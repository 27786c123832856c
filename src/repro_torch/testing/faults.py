"""Fault-injection harness for the device engine (PyTorch port).

Counterpart of :mod:`repro.testing.faults`.  It uses the
:class:`repro_torch.runtime.injection.FailureInjector` schedule to
corrupt LIVE queue snapshots between run segments (through
``CompiledSim.run``'s ``_segment_hook`` seam) and asserts the two
properties the robustness layer promises:

* **detected** — every corruption class trips the invariant auditor
  (``validate="cheap"`` bits in the stats carry, or the ``"full"``
  O(capacity) cross-tier audit at the segment boundary) as a typed
  :class:`~repro_torch.core.validate.EngineFaultError`;
* **recovered** — restoring the checkpoint saved before the corruption
  and replaying gives a final state bit-identical to a never-faulted run
  (checkpoints are saved before the injection seam fires, so the newest
  one is always clean).

Corruption classes (``CORRUPTIONS`` maps kind -> queue transform):

``nan_time``           a front slot's timestamp becomes NaN
``nonmonotone_front``  two front keys swapped out of (time, seq) order
``dup_seq``            one seq duplicated across two front slots
``truncate_run_log``   a live run's ``r_len`` rewound to ``r_off``
                       (events silently vanish from the log)
``seq_rewind``         the global seq counter rewound below queued seqs

Two engine-level scenarios ride along: ``crash`` (a simulated crash
mid-run, recovered by ``resume_from="latest"``) and ``overflow_storm``
(a queue too small for its event population: ``overflow="error"``
fails fast, ``overflow="spill"`` completes).

Every scenario builds on the card unless ``device=`` names another
device.  CLI: ``python -m repro_torch.testing.faults [--scenario crash]
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import Config, SimProgram
from repro_torch.core.validate import EngineFaultError, fault_names
from repro_torch.runtime.injection import FailureEvent, FailureInjector

I32_MAX = 2**31 - 1


class SimulatedCrash(RuntimeError):
    """Raised by the injection seam to model a mid-run process death."""


def _zero():
    """The bare event counter the harness's models carry as state."""
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------------------
# Model: a tiny self-sustaining PHOLD
# ---------------------------------------------------------------------------

def tiny_phold(*, capacity: int = 256, seeds: int = 8,
               max_batch_len: int = 4) -> SimProgram:
    """Self-sustaining PHOLD: every event reschedules one successor with
    delay in [0.4, 1.0] (declared lookahead 0.4), so the pending set
    never drains and every run bound is ``max_batches``.  The delay
    goes through ``torch.sin``, which may differ from ``jnp.sin`` by an
    ulp: hold this model's runs torch against torch."""
    prog = SimProgram("tiny_phold", config=Config(
        max_batch_len=max_batch_len, capacity=capacity, max_emit=2))

    @prog.handler("BOUNCE", lookahead=0.4, emits=True)
    def bounce(state, t, arg):
        # The clamp makes the 0.4 bound hold exactly on the f32 grid.
        d = torch.clamp(0.7 + 0.3 * torch.sin(t + arg[0]), min=0.4)
        e = torch.full((2, 6), -1.0, dtype=torch.float32, device=t.device)
        e[:, 0] = 0.0
        e[0, 0] = d
        e[0, 1] = 0.0
        e[0, 2] = arg[0] + 1.0
        return state + 1, e

    for i in range(seeds):
        prog.schedule(0.1 * i, "BOUNCE", [float(i)])
    prog.example_state(_zero())
    return prog


# ---------------------------------------------------------------------------
# Queue corruptions (tiered3 layout; each returns a new queue)
# ---------------------------------------------------------------------------

def _set(col, idx, value):
    out = col.clone()
    out[idx] = value
    return out


def _corrupt_nan_time(q):
    return q._replace(f_times=_set(q.f_times, 0, float("nan")))


def _corrupt_nonmonotone_front(q):
    t = q.f_times.clone()
    t[0], t[1] = q.f_times[1], q.f_times[0]
    return q._replace(f_times=t)


def _corrupt_dup_seq(q):
    return q._replace(f_times=_set(q.f_times, 1, q.f_times[0]),
                      f_seqs=_set(q.f_seqs, 1, q.f_seqs[0]))


def _corrupt_truncate_run_log(q):
    # Rewind the longest live run to empty: its events vanish from the
    # log while `size` still counts them.
    live = (q.r_len - q.r_off).cpu().numpy()
    i = int(np.argmax(live))
    if live[i] <= 0:
        # No live run at this boundary: vanish a front slot instead,
        # the same conservation violation (occupancy < size).
        n = int(q.front_n)
        return q._replace(
            f_times=_set(q.f_times, n - 1, float("inf")),
            f_types=_set(q.f_types, n - 1, -1),
            f_seqs=_set(q.f_seqs, n - 1, I32_MAX),
            front_n=q.front_n - 1)
    return q._replace(r_len=_set(q.r_len, i, q.r_off[i]))


def _corrupt_seq_rewind(q):
    return q._replace(next_seq=torch.zeros_like(q.next_seq))


CORRUPTIONS = {
    "nan_time": _corrupt_nan_time,
    "nonmonotone_front": _corrupt_nonmonotone_front,
    "dup_seq": _corrupt_dup_seq,
    "truncate_run_log": _corrupt_truncate_run_log,
    "seq_rewind": _corrupt_seq_rewind,
}

_MAX_BATCHES = 60
_CKPT_EVERY = 5
_CORRUPT_AT_SEG = 4


def _final_fingerprint(result):
    """Bit-comparable digest of a run: state, counters, residual queue."""
    from repro_torch.core.queue import tiered3_queue_to_flat

    flat = tiered3_queue_to_flat(result.raw["final_queue"])
    return (int(result.state), result.events, result.batches,
            result.dropped, float(result.final_time),
            flat.times.tobytes(), flat.types.tobytes(), flat.seqs.tobytes())


def run_corruption_scenario(kind: str, *, tmpdir: str,
                            validate: str = "full", sim=None,
                            device=None) -> dict:
    """Inject ``kind`` at a segment boundary; assert detection and exact
    recovery.  Returns a small report dict.  ``sim`` reuses a built
    ``tiny_phold`` CompiledSim (with ``validate != 'off'``)."""
    corrupt = CORRUPTIONS[kind]
    if sim is None:
        sim = tiny_phold().build(backend="device", validate=validate,
                                 device=device)

    # Fingerprint a never-faulted run (no checkpoint dir: it must not
    # pollute the "latest" checkpoint the recovery resumes from).
    want = _final_fingerprint(sim.run(_zero(), max_batches=_MAX_BATCHES))

    injector = FailureInjector([FailureEvent(_CORRUPT_AT_SEG, kind)])

    def hook(seg, state, queue, stats):
        if injector.poll(seg) is not None:
            return state, corrupt(queue), stats
        return None

    detected = None
    try:
        sim.run(_zero(), max_batches=_MAX_BATCHES,
                checkpoint_every=_CKPT_EVERY, checkpoint_dir=tmpdir,
                _segment_hook=hook)
    except EngineFaultError as e:
        detected = e
    if detected is None:
        raise AssertionError(f"{kind}: corruption was NOT detected")
    if not injector.fired:
        raise AssertionError(f"{kind}: injector never fired")

    # Recovery: the newest checkpoint predates the corruption.
    recovered = sim.run(_zero(), max_batches=_MAX_BATCHES,
                        checkpoint_every=_CKPT_EVERY,
                        checkpoint_dir=tmpdir, resume_from="latest")
    if _final_fingerprint(recovered) != want:
        raise AssertionError(f"{kind}: restore-and-replay diverged")
    return {"kind": kind, "detected": fault_names(detected.fault_word),
            "fault_step": detected.fault_step, "recovered": True}


def run_crash_scenario(*, tmpdir: str, validate: str = "cheap", sim=None,
                       device=None) -> dict:
    """Simulated crash mid-run; resume from the latest checkpoint and
    assert the stitched run is bit-identical to an uninterrupted one."""
    if sim is None:
        sim = tiny_phold().build(backend="device", validate=validate,
                                 device=device)
    want = _final_fingerprint(sim.run(_zero(), max_batches=_MAX_BATCHES))

    injector = FailureInjector([FailureEvent(_CORRUPT_AT_SEG, "crash")])

    def hook(seg, state, queue, stats):
        if injector.poll(seg) is not None:
            raise SimulatedCrash(f"injected crash at segment {seg}")
        return None

    try:
        sim.run(_zero(), max_batches=_MAX_BATCHES,
                checkpoint_every=_CKPT_EVERY, checkpoint_dir=tmpdir,
                _segment_hook=hook)
        raise AssertionError("crash: injected crash did not fire")
    except SimulatedCrash:
        pass

    resumed = sim.run(_zero(), max_batches=_MAX_BATCHES,
                      checkpoint_every=_CKPT_EVERY,
                      checkpoint_dir=tmpdir, resume_from="latest")
    if _final_fingerprint(resumed) != want:
        raise AssertionError("crash: resumed run diverged from clean run")
    return {"kind": "crash", "detected": ["crash"], "recovered": True}


def storm_program(cap: int) -> SimProgram:
    """The overflow storm: six seeds, each GEN before t = 2 emitting two
    more (delays 0.3 and 0.45), a population far above ``cap`` = 16."""
    p = SimProgram("storm", config=Config(
        max_batch_len=2, capacity=cap, max_emit=2))

    @p.handler("GEN", lookahead=0.1, emits=True)
    def gen(state, t, arg):
        alive = t < 2.0
        e = torch.full((2, 6), -1.0, dtype=torch.float32, device=t.device)
        e[:, 0] = 0.0
        e[0, 0] = torch.where(alive, 0.3, -1.0)
        e[0, 1] = torch.where(alive, 0.0, -1.0)
        e[1, 0] = torch.where(alive, 0.45, -1.0)
        e[1, 1] = torch.where(alive, 0.0, -1.0)
        return state + 1, e

    for i in range(6):
        p.schedule(0.05 * i, "GEN")
    return p


def run_overflow_scenario(*, validate: str = "cheap", device=None) -> dict:
    """Overflow storm: a queue too small for its event population.
    ``overflow='error'`` must fail fast with a typed overflow fault;
    ``overflow='spill'`` must complete bit-identically to an oversized
    queue with zero drops and an empty pool."""
    detected = None
    try:
        storm_program(16).build(backend="device", overflow="error",
                                validate=validate,
                                device=device).run(_zero())
    except EngineFaultError as e:
        detected = e
    if detected is None:
        raise AssertionError("overflow_storm: 'error' policy did not raise")

    big = storm_program(16384).build(backend="device",
                                     device=device).run(_zero())
    sp = storm_program(64).build(backend="device", overflow="spill",
                                 validate=validate,
                                 device=device).run(_zero())
    ok = (int(sp.state) == int(big.state) and sp.events == big.events
          and float(sp.final_time) == float(big.final_time)
          and sp.dropped == 0 and sp.spilled == 0)
    if not ok:
        raise AssertionError(
            "overflow_storm: spill run diverged from the oversized queue")
    return {"kind": "overflow_storm",
            "detected": fault_names(detected.fault_word),
            "recovered": True, "events": sp.events, "batches": sp.batches}


def run_all_scenarios(*, validate: str = "full", device=None) -> list[dict]:
    reports = []
    sim = tiny_phold().build(backend="device", validate=validate,
                             device=device)
    for kind in CORRUPTIONS:
        with tempfile.TemporaryDirectory() as d:
            reports.append(run_corruption_scenario(
                kind, tmpdir=d, validate=validate, sim=sim))
    with tempfile.TemporaryDirectory() as d:
        reports.append(run_crash_scenario(tmpdir=d, sim=sim))
    reports.append(run_overflow_scenario(device=device))
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="all",
                    choices=["all", "crash", "overflow_storm",
                             *CORRUPTIONS])
    ap.add_argument("--validate", default="full",
                    choices=["cheap", "full"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = args.device
    if args.scenario == "all":
        reports = run_all_scenarios(validate=args.validate, device=dev)
    elif args.scenario == "crash":
        with tempfile.TemporaryDirectory() as d:
            reports = [run_crash_scenario(tmpdir=d, device=dev)]
    elif args.scenario == "overflow_storm":
        reports = [run_overflow_scenario(device=dev)]
    else:
        with tempfile.TemporaryDirectory() as d:
            reports = [run_corruption_scenario(
                args.scenario, tmpdir=d, validate=args.validate,
                device=dev)]
    for r in reports:
        print(f"[fault-injection] {r['kind']}: detected={r['detected']} "
              f"recovered={r['recovered']}")
    print(f"[fault-injection] {len(reports)} scenario(s) OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
