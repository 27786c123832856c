"""The invariant auditor and the fault-injection harness of
``repro_torch``, against ``repro``'s.

* ``tiered3_fault_bits`` (both occupancy disciplines) and ``full_audit``
  give the same words and findings as JAX's on the same queues, clean
  and under each of the five corruptions, built from a JAX stream whose
  queue has a live run pool.
* The overflow storm: ``overflow="error"`` raises ``FAULT_OVERFLOW``
  and ``overflow="spill"`` matches the oversized queue with nothing
  dropped or left in the pool, in the port and against JAX's runs.
* Every corruption is detected (the bit JAX's harness expects) and
  recovered bit for bit; a crash resumes bit for bit; the entry audit
  fires before any event runs; fault names decode as JAX's do.

``tiny_phold`` goes through ``torch.sin``, which may differ from
``jnp.sin`` by an ulp, so its runs are held torch against torch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import queue as jq
from repro.core import validate as JV
from repro.testing import faults as jfaults
from repro_torch.core import validate as V
from repro_torch.core.queue import tiered3_queue_from_arrays
from repro_torch.testing import faults as tfaults

from test_torch_queue_tiered3 import random_rows

_EXPECT_BITS = {
    "nan_time": V.FAULT_TIME_NONFINITE,
    "nonmonotone_front": V.FAULT_FRONT_ORDER,
    "dup_seq": V.FAULT_FRONT_ORDER,
    "truncate_run_log": V.FAULT_CONSERVATION,
    "seq_rewind": V.FAULT_SEQ_RANGE,
}


def _to_torch(qj):
    return tiered3_queue_from_arrays(
        {f: np.asarray(getattr(qj, f)) for f in qj._fields}, "cpu")


@pytest.fixture(scope="module")
def jax_queues():
    """Queues from a JAX fill/extract stream at tiny tiers: one with a
    live run pool (so ``truncate_run_log`` rewinds a run) and one
    without (it vanishes a front slot instead)."""
    fill = jax.jit(jq.tiered3_queue_fill_rows)
    extract = jax.jit(jq.tiered3_queue_extract, static_argnums=1)
    rng = np.random.default_rng(4)
    la = jnp.asarray([0.5, 1.0, 0.0], jnp.float32)
    q = jq.tiered3_queue_init(64, front_cap=8, stage_cap=4, num_runs=3)
    out = {}
    for step in range(24):
        q = fill(q, jnp.asarray(random_rows(rng, 4, t_lo=step // 3,
                                            t_hi=step // 3 + 6)))
        if step % 3 == 2:
            q = extract(q, 4, la)[0]
        live = np.asarray(q.r_len - q.r_off)
        if live.max() > 0 and int(q.front_n) > 2:
            out.setdefault("runs", q)
    out["no_runs"] = jq.tiered3_queue_from_host(
        [(0.5 * i, 0, None) for i in range(12)], 64, front_cap=8,
        stage_cap=4, num_runs=3)
    assert set(out) == {"runs", "no_runs"}
    return out


@pytest.mark.parametrize("which", ["runs", "no_runs"])
@pytest.mark.parametrize("kind", [None, *sorted(tfaults.CORRUPTIONS)])
def test_fault_bits_and_audit_match_jax(jax_queues, which, kind):
    qj = jax_queues[which]
    qt = _to_torch(qj)
    if kind is not None:
        qj = jfaults.CORRUPTIONS[kind](qj)
        qt = tfaults.CORRUPTIONS[kind](qt)
    for local in (False, True):
        want = int(JV.tiered3_fault_bits(qj, local=local))
        got = int(V.tiered3_fault_bits(qt, local=local))
        assert got == want, (kind, local, V.fault_names(got),
                             JV.fault_names(want))
        assert V.full_audit(qt, local=local) == \
            JV.full_audit(qj, local=local), (kind, local)


def test_fault_names_and_error_match_jax():
    for word in (0, 1, 3, 48, 64, 512, 1023):
        assert V.fault_names(word) == JV.fault_names(word)
        e, je = (V.EngineFaultError(word, 7, "x"),
                 JV.EngineFaultError(word, 7, "x"))
        assert str(e) == str(je) and e.faults == je.faults
    assert V.FAULT_NAMES == JV.FAULT_NAMES
    with pytest.raises(V.EngineFaultError) as ei:
        V.raise_on_findings([(V.FAULT_CONSERVATION, "a"),
                             (V.FAULT_SEQ_RANGE, "b")], step=3)
    assert ei.value.fault_word == (V.FAULT_AUDIT | V.FAULT_CONSERVATION
                                   | V.FAULT_SEQ_RANGE)
    assert ei.value.fault_step == 3


def test_overflow_storm_error_and_spill():
    report = tfaults.run_overflow_scenario(device="cpu")
    assert report["detected"] == ["overflow"] and report["recovered"]
    # Against JAX: the same storm under spill and on the oversized queue.
    spill = tfaults.storm_program(64).build(
        device="cpu", overflow="spill", validate="full").run(tfaults._zero())
    jres = _jax_storm(64, overflow="spill")
    assert int(spill.state) == int(jres.state)
    assert spill.events == jres.events and spill.batches == jres.batches
    assert np.float32(spill.final_time) == np.float32(jres.final_time)
    assert spill.spilled == jres.spilled == 0
    assert spill.dropped == jres.dropped == 0
    with pytest.raises(V.EngineFaultError, match="overflow") as ei:
        tfaults.storm_program(16).build(device="cpu", overflow="error").run(
            tfaults._zero())
    with pytest.raises(JV.EngineFaultError) as jei:
        _jax_storm(16, overflow="error")
    assert (ei.value.fault_word, ei.value.fault_step) == \
        (jei.value.fault_word, jei.value.fault_step)


def _jax_storm(cap, **build_kw):
    """JAX's storm (``repro.testing.faults.run_overflow_scenario``'s
    program) at capacity ``cap``."""
    from repro.api import Config, SimProgram

    p = SimProgram("storm", config=Config(max_batch_len=2, capacity=cap,
                                          max_emit=2))

    @p.handler("GEN", lookahead=0.1, emits=True)
    def gen(state, t, arg):
        alive = t < 2.0
        e = jnp.full((2, 6), -1.0, jnp.float32).at[:, 0].set(0.0)
        e = e.at[0, 0].set(jnp.where(alive, 0.3, -1.0))
        e = e.at[0, 1].set(jnp.where(alive, 0.0, -1.0))
        e = e.at[1, 0].set(jnp.where(alive, 0.45, -1.0))
        e = e.at[1, 1].set(jnp.where(alive, 0.0, -1.0))
        return state + 1, e

    for i in range(6):
        p.schedule(0.05 * i, "GEN")
    return p.build(backend="device", **build_kw).run(jnp.int32(0))


@pytest.fixture(scope="module")
def phold_sim():
    return tfaults.tiny_phold().build(device="cpu", validate="full")


@pytest.mark.parametrize("kind", sorted(tfaults.CORRUPTIONS))
def test_corruption_detected_and_recovered(kind, phold_sim, tmp_path):
    report = tfaults.run_corruption_scenario(kind, tmpdir=str(tmp_path),
                                             sim=phold_sim)
    assert report["recovered"]
    assert V.fault_names(_EXPECT_BITS[kind])[0] in report["detected"]


def test_crash_resume_bit_identical(phold_sim, tmp_path):
    assert tfaults.run_crash_scenario(tmpdir=str(tmp_path),
                                      sim=phold_sim)["recovered"]


def test_entry_audit_fires_before_any_execution(phold_sim, tmp_path):
    def corrupt(seg, state, queue, stats):
        if seg == 2:
            return (state, tfaults.CORRUPTIONS["nonmonotone_front"](queue),
                    stats)
        return None

    with pytest.raises(V.EngineFaultError) as ei:
        phold_sim.run(tfaults._zero(), max_batches=40, checkpoint_every=5,
                      checkpoint_dir=str(tmp_path), _segment_hook=corrupt)
    assert ei.value.fault_step == 10
    assert "front_order" in V.fault_names(ei.value.fault_word)


def test_clean_run_reports_no_fault(phold_sim):
    res = phold_sim.run(tfaults._zero(), max_batches=20)
    assert res.fault_word == 0 and res.fault_step == -1
    assert V.full_audit(res.raw["final_queue"]) == []


def test_validated_run_makes_no_extra_host_reads():
    """A validated, an overflow='error' and a spilling run read the host
    as often per super-step as a closed one (the checks ride the one
    guard read); only the segment boundary adds reads."""
    from repro_torch.core import queue as tq

    syncs = {}
    for kw in ({}, dict(validate="cheap"), dict(overflow="error"),
               dict(overflow="spill")):
        tq.COUNTS.clear()
        res = tfaults.tiny_phold().build(device="cpu", **kw).run(
            tfaults._zero(), max_batches=50)
        assert res.batches == 50
        syncs[tuple(kw.items())] = tq.COUNTS["host_syncs"]
    closed = syncs[()]
    for key, n in syncs.items():
        assert closed <= n <= closed + 2, (key, n, closed)


def test_cli_runs_every_scenario(capsys):
    assert tfaults.main(["--scenario", "crash", "--device", "cpu"]) == 0
    assert "1 scenario(s) OK" in capsys.readouterr().out
