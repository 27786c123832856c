"""The tiered3 queue of ``repro_torch`` against ``repro``'s, field by field.

Random fill / extract streams (the shape of
``tests/test_device_queue_tiered3.py``: small integer times for heavy
ties, a quarter of the rows invalid) run through both packages from the
same starting queue, carried across with ``tiered3_queue_from_arrays``.
Every field of the queue and every window output must be BIT-IDENTICAL
after every operation.  Tiny front / staging / run-pool sizes force the
rare paths: staging flushes (suffix append, head merge, new run), ring
rotates, run-pool merges into main and k-way refills; the merge's slack-append
leg, which no stream reaches, is pinned on a constructed queue.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import queue as jq
from repro.core.events import ARG_WIDTH
from repro_torch.core import queue as tq

EMIT_W = 2 + ARG_WIDTH

_fill = jax.jit(jq.tiered3_queue_fill_rows)
_fill_tagged = jax.jit(jq.tiered3_queue_fill_rows_tagged)
_extract = jax.jit(jq.tiered3_queue_extract, static_argnums=1)
_next = jax.jit(lambda q: (jq.tiered3_queue_has_pending(q),
                           jq.tiered3_queue_occupancy(q),
                           jq.tiered3_queue_next_time(q),
                           *jq.tiered3_queue_next_key(q)))


def jax_fields(q) -> dict:
    return {f: np.asarray(getattr(q, f)) for f in q._fields}


def to_torch(qj) -> tq.Tiered3DeviceQueue:
    return tq.tiered3_queue_from_arrays(jax_fields(qj), "cpu")


def assert_queues_equal(qj, qt, msg=""):
    want = jax_fields(qj)
    got = tq.tiered3_queue_to_arrays(qt)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, f"{msg}: {name} dtype"
        np.testing.assert_array_equal(got[name], w,
                                      err_msg=f"{msg}: field {name}")


def assert_summaries_equal(qj, qt, msg=""):
    want = [np.asarray(x) for x in _next(qj)]
    got = [tq.tiered3_queue_has_pending(qt), tq.tiered3_queue_occupancy(qt),
           tq.tiered3_queue_next_time(qt), *tq.tiered3_queue_next_key(qt)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=msg)


def random_rows(rng, n_rows, *, num_types=3, t_lo=0, t_hi=6):
    rows = np.zeros((n_rows, EMIT_W), np.float32)
    rows[:, 1] = -1.0
    for i in range(n_rows):
        if rng.random() < 0.75:
            rows[i, 0] = float(rng.integers(t_lo, t_hi)) + 0.5 * rng.integers(2)
            rows[i, 1] = float(rng.integers(0, num_types))
            rows[i, 2:] = rng.random(ARG_WIDTH).astype(np.float32)
    return rows


def run_stream(seed, capacity, front_cap, stage_cap, num_runs, *,
               steps=60, n_rows=4, max_len=4, tagged=False):
    rng = np.random.default_rng(seed)
    la_np = rng.choice([0.0, 0.5, 1.0, np.inf], size=3).astype(np.float32)
    la_j, la_t = jnp.asarray(la_np), torch.tensor(la_np)
    qj = jq.tiered3_queue_init(capacity, front_cap=front_cap,
                               stage_cap=stage_cap, num_runs=num_runs)
    qt = to_torch(qj)
    clock = 0.0
    for step in range(steps):
        msg = f"seed {seed} step {step}"
        if rng.random() < 0.55:
            rows = random_rows(rng, n_rows, t_lo=int(clock),
                               t_hi=int(clock) + 6)
            if tagged:
                seqs = (int(qj.next_seq)
                        + np.arange(n_rows, dtype=np.int32))
                keep = rng.random(n_rows) < 0.8
                qj = _fill_tagged(qj, jnp.asarray(rows), jnp.asarray(seqs),
                                  jnp.asarray(keep))
                qt = tq.tiered3_queue_fill_rows_tagged(
                    qt, torch.tensor(rows), torch.tensor(seqs),
                    torch.tensor(keep))
            else:
                qj = _fill(qj, jnp.asarray(rows))
                qt = tq.tiered3_queue_fill_rows(qt, torch.tensor(rows))
        else:
            cap = None if rng.random() < 0.5 else clock + 2.0
            qj, tsj, tyj, aj, lj = _extract(
                qj, max_len, la_j, None if cap is None else jnp.float32(cap))
            qt, tst, tyt, at, lt = tq.tiered3_queue_extract(
                qt, max_len, la_t, cap)
            np.testing.assert_array_equal(tst.numpy(), np.asarray(tsj), msg)
            np.testing.assert_array_equal(tyt.numpy(), np.asarray(tyj), msg)
            np.testing.assert_array_equal(at.numpy(), np.asarray(aj), msg)
            assert int(lt) == int(lj), msg
            if int(lj):
                clock = float(np.asarray(tsj)[int(lj) - 1])
        assert_queues_equal(qj, qt, msg)
        assert_summaries_equal(qj, qt, msg)


# Tiny tiers and pools force every rare path (the tiered3 suite's
# configurations, plus one with room for the head-merge window).
CONFIGS = [(6, 4, 1), (4, 5, 2), (5, 7, 3), (24, 24, 2), (8, 40, 1),
           (8, 8, 2)]


@pytest.mark.parametrize("front_cap,stage_cap,num_runs", CONFIGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fill_extract_stream_bit_identical(seed, front_cap, stage_cap,
                                           num_runs):
    run_stream(seed, 24, front_cap, stage_cap, num_runs)


@pytest.mark.parametrize("seed", [2, 3])
def test_tagged_fill_stream_bit_identical(seed):
    run_stream(seed, 32, 8, 8, 2, tagged=True)


def test_stream_exercises_every_rare_path():
    """The streams above must actually reach the paths they claim to
    pin: count the port's rare-path firings over a few of them.  (The
    slack-append leg of the run-pool merge is not in the list: no
    single-queue stream reaches it, because a run's elements never
    follow the main tail while the main ring is non-empty.)"""
    tq.COUNTS.clear()
    for seed in range(4):
        for cfg in [(6, 4, 1), (4, 5, 2), (8, 8, 2)]:
            run_stream(seed, 24, *cfg, steps=40)
    for path in ("flush", "rotate", "suffix_append", "head_merge",
                 "to_run", "merge_compact", "refill_kway",
                 "refill_main_only"):
        assert tq.COUNTS[path] > 0, (path, dict(tq.COUNTS))


@pytest.mark.parametrize("capacity", [6, 40])
def test_from_host_matches_jax(capacity):
    """Seed builds agree, including overflow past capacity, ties and
    the front/main split."""
    rng = np.random.default_rng(capacity)
    events = [(float(rng.integers(0, 4)), int(rng.integers(0, 3)),
               rng.random(ARG_WIDTH).astype(np.float32)) for _ in range(9)]
    events.append((1.0, 0, None))
    qj = jq.tiered3_queue_from_host(events, capacity, front_cap=4,
                                    stage_cap=4, num_runs=2)
    qt = tq.tiered3_queue_from_host(events, capacity, front_cap=4,
                                    stage_cap=4, num_runs=2)
    assert_queues_equal(qj, qt, "from_host")


def test_peek_and_pop_prefix_match_jax():
    rng = np.random.default_rng(5)
    events = [(float(rng.integers(0, 5)), int(rng.integers(0, 2)), None)
              for _ in range(20)]
    qj = jq.tiered3_queue_from_host(events, 32, front_cap=4, stage_cap=4,
                                    num_runs=2)
    qt = to_torch(qj)
    for step in range(6):
        qj, *cj = jq.tiered3_queue_peek_front(qj, 3)
        qt, *ct = tq.tiered3_queue_peek_front(qt, 3)
        for a, b in zip(cj, ct):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        n = step % 3
        qj = jq.tiered3_queue_pop_prefix(qj, jnp.int32(n), 3)
        qt = tq.tiered3_queue_pop_prefix(
            qt, torch.tensor(n, dtype=torch.int32), 3)
        assert_queues_equal(qj, qt, f"peek/pop step {step}")


def test_overflow_ghosts_match_jax():
    """Emits past the logical capacity are dropped with the reference
    size / next_seq / dropped accounting, across all tiers."""
    qj = jq.tiered3_queue_init(8, front_cap=4, stage_cap=3, num_runs=2)
    qt = to_torch(qj)
    for lo in (0, 3, 6, 1, 100):
        rows = np.zeros((3, EMIT_W), np.float32)
        rows[:, 0] = np.arange(lo, lo + 3)
        rows[:, 1] = [0.0, 1.0, -1.0 if lo == 6 else 0.0]
        qj = _fill(qj, jnp.asarray(rows))
        qt = tq.tiered3_queue_fill_rows(qt, torch.tensor(rows))
        assert_queues_equal(qj, qt, f"fill at {lo}")
    assert int(qt.dropped) > 0


@pytest.mark.parametrize("run_times,leg", [
    ([[5.0, 6.0, np.inf], [np.inf, 4.0, 7.0]], "merge_append"),
    ([[0.5, 2.5, np.inf], [np.inf, 4.0, 7.0]], "merge_compact"),
])
def test_merge_runs_into_main_both_legs(run_times, leg):
    """Both legs of the run-pool drain on a queue built field by field:
    runs that all follow the main tail append into the ring's slack,
    runs that interleave with main take the compaction."""
    q0 = jq.tiered3_queue_init(8, front_cap=2, stage_cap=3, num_runs=2)
    fields = {k: v.copy() for k, v in jax_fields(q0).items()}
    fields["m_times"][3:6] = [1.0, 2.0, 3.0]
    fields["m_types"][3:6] = 0
    fields["m_seqs"][3:6] = [0, 1, 2]
    fields["m_args"][3:6, 0] = [10.0, 11.0, 12.0]
    fields["m_head"] = np.int32(3)
    fields["main_n"] = np.int32(3)
    rt = np.asarray(run_times, np.float32)
    fields["r_times"] = rt
    fields["r_types"] = np.where(np.isfinite(rt), 1, -1).astype(np.int32)
    fields["r_seqs"] = np.where(np.isfinite(rt),
                                np.arange(6).reshape(2, 3) + 10,
                                2**31 - 1).astype(np.int32)
    fields["r_args"][..., 1] = np.arange(6, dtype=np.float32).reshape(2, 3)
    fields["r_off"] = np.asarray([0, 1], np.int32)
    fields["r_len"] = np.asarray([2, 3], np.int32)
    fields["size"] = fields["next_seq"] = np.int32(7)
    qj = jq.Tiered3DeviceQueue(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    qt = tq.tiered3_queue_from_arrays(fields, "cpu")
    tq.COUNTS.clear()
    qj = jax.jit(jq._merge_runs_into_main)(qj)
    qt = tq._merge_runs_into_main(qt)
    assert tq.COUNTS[leg] == 1
    assert_queues_equal(qj, qt, leg)
