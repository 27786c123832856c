"""The two-tier, flat and reference queue modes of ``repro_torch`` against
``repro``'s, field by field.

The streams of ``tests/test_device_queue_tiered.py`` and
``tests/test_device_queue_vectorized.py`` (small integer times for heavy
ties, a third of the rows invalid) run through both packages from the
same starting queue; every field of the queue and every window output
must be BIT-IDENTICAL after every operation.  Tiny tiers force the
two-tier rare paths (front eviction, the staging flush's append and
merge legs, refills).  Then the engine: PoC and PHOLD in the three
modes against JAX's runs, with the cheap fault bits and the full audit
on, the fault words and audits of corrupted queues against JAX's, and
the host reads a super-step makes.  Tolerance: exact.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import poc as jpoc
from repro.core import queue as jq
from repro.core import validate as JV
from repro.core.events import ARG_WIDTH
from repro.core.program import Config as JConfig
from repro_torch.api import Config as TConfig
from repro_torch.core import queue as tq
from repro_torch.core import validate as V
from repro_torch.examples import phold as tphold
from repro_torch.examples import poc as tpoc

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import phold as jphold  # noqa: E402  (examples/ is not a package)

EMIT_W = 2 + ARG_WIDTH
MODES = ("tiered", "flat", "reference")

_J = {
    "tiered": (jax.jit(jq.tiered_queue_fill_rows),
               jax.jit(jq.tiered_queue_extract, static_argnums=1)),
    "flat": (jax.jit(jq.device_queue_fill_rows),
             jax.jit(jq.device_queue_extract, static_argnums=1)),
    "reference": (jax.jit(jq.device_queue_push_rows),
                  jax.jit(jq.device_queue_extract_ref, static_argnums=1)),
}
_T = {
    "tiered": (tq.tiered_queue_fill_rows, tq.tiered_queue_extract),
    "flat": (tq.device_queue_fill_rows, tq.device_queue_extract),
    "reference": (tq.device_queue_push_rows, tq.device_queue_extract_ref),
}


def jax_fields(q) -> dict:
    return {f: np.asarray(getattr(q, f)) for f in q._fields}


def to_torch(qj):
    cls = (tq.TieredDeviceQueue if hasattr(qj, "s_evict")
           else tq.DeviceQueue)
    return tq.queue_from_arrays(cls, jax_fields(qj), "cpu")


def assert_queues_equal(qj, qt, msg=""):
    want = jax_fields(qj)
    got = tq.queue_to_arrays(qt)
    assert list(got) == list(want), msg
    for name, w in want.items():
        assert got[name].dtype == w.dtype, f"{msg}: {name} dtype"
        np.testing.assert_array_equal(got[name], w,
                                      err_msg=f"{msg}: field {name}")


def assert_windows_equal(wj, wt, msg=""):
    for a, b in zip(wj, wt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=msg)


def random_rows(rng, n_rows, *, p_valid=0.7, num_types=3, t_lo=0, t_hi=5):
    rows = np.zeros((n_rows, EMIT_W), np.float32)
    rows[:, 1] = -1.0
    for i in range(n_rows):
        if rng.random() < p_valid:
            rows[i, 0] = float(rng.integers(t_lo, t_hi))
            rows[i, 1] = float(rng.integers(0, num_types))
            rows[i, 2:] = rng.random(ARG_WIDTH).astype(np.float32)
    return rows


def init_pair(mode, capacity, front_cap=None, stage_cap=None):
    if mode == "tiered":
        qj = jq.tiered_queue_init(capacity, front_cap=front_cap,
                                  stage_cap=stage_cap)
    else:
        qj = jq.device_queue_init(capacity)
    return qj, to_torch(qj)


def step_pair(mode, qj, qt, op, arg, la_np, msg, window=False):
    """One fill (``arg`` the rows) or extract (``arg`` the window
    length) in both packages, the outputs compared; ``window=True``
    also returns the port's window ``(ts, tys, args, length)``."""
    fill_j, extract_j = _J[mode]
    fill_t, extract_t = _T[mode]
    wt = None
    if op == "fill":
        qj = fill_j(qj, jnp.asarray(arg))
        qt = fill_t(qt, torch.tensor(arg))
    else:
        qj, *wj = extract_j(qj, arg, jnp.asarray(la_np))
        qt, *wt = extract_t(qt, arg, torch.tensor(la_np))
        assert_windows_equal(wj, wt, msg)
    assert_queues_equal(qj, qt, msg)
    return (qj, qt, wt) if window else (qj, qt)


def run_stream(seed, mode, capacity=24, front_cap=None, stage_cap=None,
               steps=50, n_rows=4, max_len=4):
    rng = np.random.default_rng(seed)
    la = rng.choice([0.0, 0.5, 1.0, np.inf], size=3).astype(np.float32)
    qj, qt = init_pair(mode, capacity, front_cap, stage_cap)
    for step in range(steps):
        msg = f"{mode} seed {seed} step {step}"
        if rng.random() < 0.5:
            qj, qt = step_pair(mode, qj, qt, "fill",
                               random_rows(rng, n_rows), la, msg)
        else:
            qj, qt = step_pair(mode, qj, qt, "extract", max_len, la, msg)
    return qt


# The two-tier suite's tiny tiers: eviction, flush and refill on most
# steps; stage_cap > capacity takes the merge leg only.
@pytest.mark.parametrize("front_cap,stage_cap", [(6, 4), (8, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_stream_bit_identical(seed, front_cap, stage_cap):
    run_stream(seed, "tiered", front_cap=front_cap, stage_cap=stage_cap)


@pytest.mark.parametrize("mode", ["flat", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flat_and_reference_streams_bit_identical(seed, mode):
    run_stream(seed, mode, steps=30,
               n_rows=int(np.random.default_rng(seed).integers(1, 8)))


def test_staging_spill_and_append_fast_path():
    """Far-future rows take the staging append, near rows the front
    merge and eviction: both flush legs fire, bit-identical to JAX."""
    rng = np.random.default_rng(42)
    la = np.asarray([1.0, 1.0, 1.0], np.float32)
    # The stream tests' geometry, so JAX compiles no new shapes.
    qj, qt = init_pair("tiered", 24, 6, 4)
    tq.COUNTS.clear()
    t_clock = 0.0
    for step in range(40):
        rows = np.zeros((4, EMIT_W), np.float32)
        rows[:, 1] = -1.0
        for i in range(4):
            r = rng.random()
            if r < 0.6:
                rows[i, 0] = t_clock + 10 + float(rng.integers(0, 5))
                rows[i, 1] = float(rng.integers(0, 3))
            elif r < 0.8:
                rows[i, 0] = t_clock + float(rng.integers(0, 3))
                rows[i, 1] = float(rng.integers(0, 3))
        msg = f"spill step {step}"
        qj, qt = step_pair("tiered", qj, qt, "fill", rows, la, msg)
        qj, qt, (ts, _, _, length) = step_pair("tiered", qj, qt, "extract",
                                               4, la, msg, window=True)
        if int(length):
            t_clock = float(ts[int(length) - 1])
    for path in ("flush_append", "flush_merge", "refill_main_only"):
        assert tq.COUNTS[path] > 0, (path, dict(tq.COUNTS))


def test_pop_order_bit_exact_under_ties():
    """One-event windows pop the two-tier queue in the reference
    queue's lex ``(time, seq)`` order; serial pushes and pops of the
    port's reference queue match JAX's."""
    rng = np.random.default_rng(7)
    la = np.asarray([0.0, 0.0], np.float32)
    events = [(float(rng.integers(0, 3)), int(rng.integers(0, 2)),
               np.full((ARG_WIDTH,), float(i), np.float32))
              for i in range(12)]
    qj = jq.tiered_queue_from_host(events, 16, front_cap=4, stage_cap=4)
    qt = tq.tiered_queue_from_host(events, 16, front_cap=4, stage_cap=4)
    assert_queues_equal(qj, qt, "from_host")
    push, pop = jax.jit(jq.device_queue_push), jax.jit(jq.device_queue_pop)
    rj = jq.device_queue_init(16)
    rt = tq.device_queue_init(16)
    for (t, ty, arg) in events:
        rj = push(rj, t, ty, jnp.asarray(arg))
        rt = tq.device_queue_push(rt, t, ty, torch.tensor(arg))
    assert_queues_equal(rj, rt, "serial pushes")
    for i in range(12):
        qj, qt, (ts, tys, args, length) = step_pair(
            "tiered", qj, qt, "extract", 1, la, f"pop {i}", window=True)
        rj, *pj = pop(rj)
        rt, t, ty, arg = tq.device_queue_pop(rt)
        assert_windows_equal(pj, (t, ty, arg), f"pop {i}")
        assert_queues_equal(rj, rt, f"pop {i}")
        assert int(length) == 1
        assert (float(ts[0]), int(tys[0])) == (float(t), int(ty))
        assert torch.equal(args[0], arg)
    assert int(qt.size) == 0 and int(rt.size) == 0


@pytest.mark.parametrize("mode", MODES)
def test_overflow_across_tiers_and_drain(mode):
    """Fill to exactly capacity with a hole, overflow with a row that
    would land in the front, then drain: ghosts stay in ``size``."""
    kw = dict(front_cap=4, stage_cap=3) if mode == "tiered" else {}
    qj, qt = init_pair(mode, 8, **kw)
    la = np.asarray([np.inf, np.inf], np.float32)
    for lo in (0, 3, 6):
        rows = np.zeros((3, EMIT_W), np.float32)
        rows[:, 0] = np.arange(lo, lo + 3)
        rows[:, 1] = 0.0
        if lo == 6:
            rows[2, 1] = -1.0
        qj, qt = step_pair(mode, qj, qt, "fill", rows, la, f"fill {lo}")
    over = np.zeros((3, EMIT_W), np.float32)
    over[:, 0] = [100.0, 0.5, 102.0]
    over[:, 1] = [1.0, 1.0, -1.0]
    qj, qt = step_pair(mode, qj, qt, "fill", over, la, "overflow")
    assert int(qt.dropped) == 2 and int(qt.size) == 10
    for i in range(4):
        qj, qt = step_pair(mode, qj, qt, "extract", 4, la, f"drain {i}")
    assert int(qt.size) == 2


@pytest.mark.parametrize("mode", ["flat", "reference"])
def test_empty_block_empty_queue_and_from_host(mode):
    """An all-empty emit block changes nothing, an extract on an empty
    queue takes nothing, and the host seed (with overflow past
    capacity) matches JAX's."""
    la = np.asarray([1.0], np.float32)
    qj, qt = init_pair(mode, 8)
    qj, qt = step_pair(mode, qj, qt, "extract", 4, la, "empty extract")
    assert int(qt.size) == 0
    rows = np.full((4, EMIT_W), -1.0, np.float32)
    qj, qt = step_pair(mode, qj, qt, "fill", rows, la, "empty block")
    rng = np.random.default_rng(3)
    events = [(float(rng.integers(0, 4)), int(rng.integers(0, 3)),
               rng.random(ARG_WIDTH).astype(np.float32)) for _ in range(9)]
    qj = jq.device_queue_from_host(events, 6)
    qt = tq.device_queue_from_host(events, 6)
    assert_queues_equal(qj, qt, "from_host")
    assert int(qt.dropped) == 3
    qj, qt = step_pair(mode, qj, qt, "fill", rows, la, "empty block, full")


def _tie_rows(times, types):
    rows = np.zeros((len(times), EMIT_W), np.float32)
    rows[:, 0] = times
    rows[:, 1] = types
    for i in range(len(times)):
        rows[i, 2:] = i + 1
    return rows


def test_push_rows_bulk_matches_serial_full_queue_and_ties():
    """The one-scatter reference insert places every row where serial
    pushes do, through ties, an exactly full queue, a ghost block and a
    refill over the holes an extract leaves; JAX agrees field by
    field."""
    la = np.asarray([1.0, 1.0, 1.0], np.float32)
    qj, qt = init_pair("reference", 8)
    qs = tq.device_queue_init(8)
    blocks = [_tie_rows([3.0, 3.0, 3.0, 3.0], [0, 1, 2, 0]),
              _tie_rows([1.0, 2.0, 1.0, 2.0], [1, -1, 0, 2]),
              _tie_rows([0.5, 0.5], [2, 2]),
              _tie_rows([9.0, 9.0, 9.0], [0, 0, 0]),
              3,
              _tie_rows([4.0, 4.0], [1, 1])]
    for i, blk in enumerate(blocks):
        if isinstance(blk, int):
            qj, qt = step_pair("reference", qj, qt, "extract", blk, la,
                               f"block {i}")
            qs, *_ = tq.device_queue_extract_ref(qs, blk, torch.tensor(la))
        else:
            qj, qt = step_pair("reference", qj, qt, "fill", blk, la,
                               f"block {i}")
            qs = tq.device_queue_push_rows_serial(qs, torch.tensor(blk))
        for name, a, b in zip(qt._fields, qt, qs):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f"block {i}: {name}")
        if i == 3:   # 12 logical pushes into 8 slots, then the ghosts
            assert int(qt.dropped) == 4 and int(qt.size) == 12


@pytest.mark.parametrize("seed", [0, 1])
def test_push_rows_bulk_matches_serial_random_streams(seed):
    rng = np.random.default_rng(seed)
    la = rng.choice([0.0, 1.0, np.inf], size=3).astype(np.float32)
    qb = tq.device_queue_init(12)
    qs = tq.device_queue_init(12)
    for step in range(40):
        if rng.random() < 0.6:
            rows = torch.tensor(random_rows(rng, 4))
            qb = tq.device_queue_push_rows(qb, rows)
            qs = tq.device_queue_push_rows_serial(qs, rows)
        else:
            qb, *wb = tq.device_queue_extract_ref(qb, 3, torch.tensor(la))
            qs, *ws = tq.device_queue_extract_ref(qs, 3, torch.tensor(la))
            for a, b in zip(wb, ws):
                assert torch.equal(a, b)
        for name, a, b in zip(qb._fields, qb, qs):
            assert torch.equal(a, b), f"seed {seed} step {step}: {name}"


def test_to_flat_views_match_jax():
    qj, qt = init_pair("tiered", 24, 6, 4)
    rng = np.random.default_rng(9)
    la = np.asarray([1.0, 0.5, 0.0], np.float32)
    for step in range(12):
        qj, qt = step_pair("tiered", qj, qt, "fill",
                           random_rows(rng, 4), la, f"fill {step}")
    fj, ft = jq.tiered_queue_to_flat(qj), tq.tiered_queue_to_flat(qt)
    for name in ("times", "types", "args", "seqs", "size", "next_seq",
                 "dropped"):
        np.testing.assert_array_equal(getattr(ft, name),
                                      np.asarray(getattr(fj, name)), name)


# ---------------------------------------------------------------------------
# Fault bits and audits
# ---------------------------------------------------------------------------

def _corrupt(fields, kind, prefix):
    """One corruption of a queue's arrays (``prefix`` the column set:
    ``f_`` for the two-tier front, ``""`` for a flat queue)."""
    f = {k: v.copy() for k, v in fields.items()}
    if kind == "nan_time":
        f[f"{prefix}times"][0] = np.nan
    elif kind == "nonmonotone":
        f[f"{prefix}times"][[0, 1]] = f[f"{prefix}times"][[1, 0]]
        f[f"{prefix}seqs"][[0, 1]] = f[f"{prefix}seqs"][[1, 0]]
        f[f"{prefix}times"][0] += 1.0
    elif kind == "seq_range":
        f[f"{prefix}seqs"][0] = f["next_seq"]
    elif kind == "conservation":
        f["size"] = f["size"] + 1
    elif kind == "dup_seq":
        f[f"{prefix}seqs"][1] = f[f"{prefix}seqs"][0]
    return f


@pytest.mark.parametrize("mode", MODES)
def test_fault_bits_and_audit_match_jax(mode):
    """Clean and corrupted queues give JAX's cheap fault word and full
    audit findings."""
    rng = np.random.default_rng(5)
    la = np.asarray([0.5, 1.0, 0.0], np.float32)
    kw = dict(front_cap=6, stage_cap=4) if mode == "tiered" else {}
    qj, qt = init_pair(mode, 24, **kw)
    for step in range(10):
        qj, qt = step_pair(mode, qj, qt, "fill",
                           random_rows(rng, 4, t_lo=0, t_hi=9), la, "fill")
    if mode == "tiered":
        jbits, tbits = JV.tiered_fault_bits, V.tiered_fault_bits
        prefix = "f_"
    else:
        srt = mode == "flat"
        jbits = lambda q: JV.flat_fault_bits(q, sorted_layout=srt)  # noqa
        tbits = lambda q: V.flat_fault_bits(q, sorted_layout=srt)  # noqa
        prefix = ""
    fields = jax_fields(qj)
    for kind in ("clean", "nan_time", "nonmonotone", "seq_range",
                 "conservation", "dup_seq"):
        f = _corrupt(fields, kind, prefix)
        cj = type(qj)(**{k: jnp.asarray(v) for k, v in f.items()})
        ct = tq.queue_from_arrays(type(qt), f, "cpu")
        word = int(tbits(ct))
        assert word == int(jbits(cj)), (mode, kind)
        assert V.full_audit(ct) == JV.full_audit(cj), (mode, kind)
        if kind == "clean":
            assert word == 0 and not V.full_audit(ct)
        elif kind in ("nan_time", "conservation"):
            assert word, (mode, kind)


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def assert_run_parity(jres, tres, msg=""):
    jleaves = jax.tree_util.tree_leaves(jres.state)
    tleaves = tree_leaves(tres.state)
    assert len(jleaves) == len(tleaves)
    for jl, tl in zip(jleaves, tleaves):
        want = np.asarray(jl)
        got = tl.numpy()
        if want.dtype == np.uint32:      # u32 leaves live in int64
            want = want.astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=msg)
    for name in ("events", "batches", "dropped", "emitted", "pending",
                 "fault_word"):
        assert getattr(tres, name) == getattr(jres, name), (msg, name)
    assert np.float32(tres.final_time) == np.float32(jres.final_time), msg
    np.testing.assert_array_equal(tres.word_counts,
                                  np.asarray(jres.word_counts), msg)
    assert_queues_equal(jres.raw["final_queue"], tres.raw["final_queue"],
                        msg)


def _poc(cfg_cls, mod):
    return mod.build_program(iters=8, config=cfg_cls(max_batch_len=2,
                                                     capacity=128))


@pytest.mark.parametrize("mode", MODES)
def test_engine_modes_match_jax_poc_and_phold(mode):
    """PoC and PHOLD in each mode, ``validate="cheap"`` on PoC and
    ``"full"`` on PHOLD: every counter, the fault word, the word
    histogram, the state and every field of the final queue equal
    JAX's; a flat or reference super-step reads the host twice (the
    guard and the window), a two-tier one at most four times."""
    kw = dict(front_cap=8, stage_cap=8) if mode == "tiered" else {}
    evs = jpoc.schedule_poc_events(96, 0.3, seed=3)
    jres = _poc(JConfig, jpoc).build(backend="device", queue_mode=mode,
                                     validate="cheap", **kw).run(
        jpoc.initial_state(), events=evs)
    tres = _poc(TConfig, tpoc).build(backend="device", device="cpu",
                                     queue_mode=mode, validate="cheap",
                                     **kw).run(tpoc.initial_state(),
                                               events=evs)
    assert_run_parity(jres, tres, f"poc {mode}")

    jres = jphold.build_program(num_lps=16, t_stop=30.0, capacity=64).build(
        backend="device", queue_mode=mode, validate="full", **kw).run(
        jphold.initial_state(16))
    tq.COUNTS.clear()
    tres = tphold.build_program(num_lps=16, t_stop=30.0, capacity=64).build(
        backend="device", device="cpu", queue_mode=mode, validate="full",
        **kw).run(tphold.initial_state(16))
    assert_run_parity(jres, tres, f"phold {mode}")
    reads = tq.COUNTS["loop_syncs"]
    if mode == "tiered":
        rare = tq.COUNTS["flush"] + tq.COUNTS["refill_main_only"]
        assert reads <= 4 * tres.batches + 1 + 2 * rare
        assert tq.COUNTS["flush"] > 0
    else:
        # The last guard read ends the loop.
        assert reads == 2 * tres.batches + 1


def test_engine_overflow_cascade_and_refusals():
    """A spawning cascade overflows a tiny queue identically in the
    three modes and in JAX; spill, absorbs and streams refuse the
    non-tiered3 modes with JAX's errors."""
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.events import EventRegistry, emits_events

    def make_reg():
        reg = EventRegistry()

        @emits_events
        def spawner(state, t, arg):
            emit = torch.zeros((2, EMIT_W))
            emit[:, 0] = t + 1.0
            emit[:, 1] = 0.0
            return state + 1, emit

        reg.register("S", spawner, lookahead=1.0)
        return reg.freeze()

    outcomes = {}
    for mode in MODES:
        kw = dict(front_cap=2, stage_cap=5) if mode == "tiered" else {}
        eng = DeviceEngine(make_reg(), max_batch_len=2, capacity=4,
                           max_emit=2, queue_mode=mode, device="cpu", **kw)
        q = eng.initial_queue([(0.0, 0, None)])
        s, q, stats = eng.run(torch.tensor(0), q, max_batches=8)
        outcomes[mode] = (int(s), int(stats["dropped"]), int(q.size),
                          int(q.next_seq), stats["batches"])
    assert outcomes["tiered"] == outcomes["flat"] == outcomes["reference"]
    assert outcomes["tiered"][1] > 0

    with pytest.raises(ValueError, match="tiered3"):
        DeviceEngine(make_reg(), queue_mode="flat", overflow="spill",
                     device="cpu")
    eng = DeviceEngine(make_reg(), queue_mode="tiered", device="cpu")
    with pytest.raises(ValueError, match="tiered3"):
        eng.absorb_rows(eng.initial_queue([]), torch.zeros((1, EMIT_W)),
                        torch.zeros(1, dtype=torch.int32))
    stats = eng.initial_run_stats()
    stats["bound_t"] = torch.tensor(1.0)
    stats["bound_seq"] = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="fence"):
        eng.run(torch.tensor(0), eng.initial_queue([]), stats=stats)
    with pytest.raises(ValueError, match="unknown queue_mode"):
        DeviceEngine(make_reg(), queue_mode="heap", device="cpu")
