"""The queue's fence and lex modes in ``repro_torch`` against ``repro``'s.

* The fenced extract: ``window_extract_plain(bound=)`` and
  ``tiered3_queue_extract(bound=)`` against JAX's bounded XLA extract,
  the fence at each candidate, on time ties with the fence's seq below
  and above the candidate's, and at ``(inf, 2**31-1)``.
* The lex fill: ``_tiered_fill_finish(b_seq=)`` and
  ``tiered3_queue_absorb_rows`` (with and without the ``insert`` mask)
  against JAX's on replayed streams: seeds, a reserved arrival range
  absorbed block by block under the fence, fresh emits and fenced
  extracts interleaved, every queue field compared after every step.
* ``tiered3_queue_to_flat`` against JAX's.

JAX's queue functions run with ``kernels="xla"`` (the Pallas extract
has no fence).  Every comparison is bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import queue as jq
from repro.core.events import ARG_WIDTH
from repro_torch.core import queue as tq
from repro_torch.kernels import queue_front as tkf

from test_torch_queue_tiered3 import (
    assert_queues_equal,
    assert_summaries_equal,
    jax_fields,
    random_rows,
    to_torch,
)

EMIT_W = 2 + ARG_WIDTH
I32_MAX = 2**31 - 1

_extract_bound = jax.jit(
    lambda q, la, cap, b_t, b_s: jq.tiered3_queue_extract(
        q, 4, la, cap, bound=(b_t, b_s)))
_fill = jax.jit(jq.tiered3_queue_fill_rows)
_absorb = jax.jit(jq.tiered3_queue_absorb_rows)


@jax.jit
def _lex_fill_j(q, rows, seqs, insert):
    """JAX's pre-flush, boundary key and lex fill finish, one program."""
    q = jq._tiered3_preflush(q, rows.shape[0])
    b_t, b_s = jq._tiered3_boundary_key(q)
    counters = dict(size=q.size, next_seq=q.next_seq, dropped=q.dropped)
    q = jq._tiered_fill_finish(q, rows, b_t, seqs,
                               insert & (rows[:, 1] >= 0), counters,
                               b_seq=b_s)
    return q, b_t, b_s


def _bound(t, s):
    return (torch.tensor(np.float32(t)), torch.tensor(np.int32(s)))


def _seeded_queue(rng, n, capacity, front_cap, stage_cap, num_runs,
                  t_hi=6):
    """The same host-built seed queue in both packages."""
    times = rng.integers(0, t_hi, n) * 0.5
    events = [(float(t), int(rng.integers(0, 3)),
               rng.random(ARG_WIDTH).astype(np.float32)) for t in times]
    qj = jq.tiered3_queue_from_host(events, capacity, front_cap=front_cap,
                                    stage_cap=stage_cap, num_runs=num_runs)
    return qj, to_torch(qj)


# ---------------------------------------------------------------------------
# the fenced extract
# ---------------------------------------------------------------------------

def _front_only(rng, F, k):
    """A queue whose pending set is its front alone (the extract does no
    refill), with heavy time ties."""
    return _seeded_queue(rng, F, 4 * F, F, 8, 1, t_hi=3)


@pytest.mark.parametrize("seed", range(2))
def test_fenced_window_extract_plain_matches_jax(seed):
    rng = np.random.default_rng(seed)
    F, k = 16, 4
    qj, qt = _front_only(rng, F, k)
    la_np = np.array([0.5, 1.0, 0.0], np.float32)
    la_j, la_t = jnp.asarray(la_np), torch.tensor(la_np)
    ft, fs = qt.f_times.numpy(), qt.f_seqs.numpy()
    fences = [(np.inf, I32_MAX)]
    for i in range(k):           # at each candidate, and tied around it
        fences += [(ft[i], fs[i]), (ft[i], fs[i] + 1), (ft[i], fs[i] - 1),
                   (ft[i], 0), (ft[i], I32_MAX)]
    for b_t, b_s in fences:
        for cap in (None, 1.0):
            want = _extract_bound(qj, la_j,
                                  None if cap is None else jnp.float32(cap),
                                  jnp.float32(b_t), jnp.int32(b_s))
            got = tkf.window_extract_plain(
                qt.f_times, qt.f_types, qt.f_args, qt.f_seqs, la_t, cap,
                k=k, bound=_bound(b_t, b_s))
            ts, tys, args, length = (np.asarray(x) for x in want[1:])
            wq = want[0]
            for g, w in zip(got, (ts, tys, args, length, wq.f_times,
                                  wq.f_types, wq.f_args, wq.f_seqs)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"fence {b_t, b_s}")


def test_open_fence_equals_no_fence():
    rng = np.random.default_rng(9)
    _, qt = _front_only(rng, 16, 4)
    la = torch.tensor([0.5, 1.0, 0.0])
    cols = (qt.f_times, qt.f_types, qt.f_args, qt.f_seqs, la)
    for a, b in zip(tkf.window_extract_plain(*cols, k=4),
                    tkf.window_extract_plain(*cols, k=4,
                                             bound=_bound(np.inf, I32_MAX))):
        assert torch.equal(a, b)


def test_fence_below_every_candidate_takes_nothing():
    rng = np.random.default_rng(3)
    _, qt = _front_only(rng, 16, 4)
    la = torch.tensor([0.5, 1.0, 0.0])
    b = _bound(qt.f_times[0].item(), qt.f_seqs[0].item())
    out = tkf.window_extract_plain(qt.f_times, qt.f_types, qt.f_args,
                                   qt.f_seqs, la, k=4, bound=b)
    assert int(out[3]) == 0
    assert torch.equal(out[4], qt.f_times)


# ---------------------------------------------------------------------------
# the lex fill and the absorb, on replayed streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_lex_fill_finish_matches_jax(seed):
    """``_tiered_fill_finish(b_seq=)`` on rows with old seqs that tie
    queued times, against the boundary key's seq."""
    rng = np.random.default_rng(seed)
    qj, qt = _seeded_queue(rng, 40, 64, 8, 16, 2, t_hi=4)
    for step in range(6):
        R = 12
        rows = random_rows(rng, R, t_lo=0, t_hi=4)
        seqs = rng.permutation(200)[:R].astype(np.int32)   # old and new
        insert = rng.random(R) < 0.8
        qj, b_t, b_s = _lex_fill_j(qj, jnp.asarray(rows), jnp.asarray(seqs),
                                   jnp.asarray(insert))
        qt = tq._tiered3_preflush(qt, R)
        tb_t, tb_s = tq._tiered3_boundary_key(qt)
        assert float(tb_t) == float(b_t) and int(tb_s) == int(b_s)
        rows_t = torch.tensor(rows)
        qt = tq._tiered_fill_finish(
            qt, rows_t, tb_t, torch.tensor(seqs),
            torch.tensor(insert) & (rows_t[:, 1] >= 0),
            dict(size=qt.size, next_seq=qt.next_seq, dropped=qt.dropped),
            b_seq=tb_s)
        assert_queues_equal(qj, qt, f"seed {seed} step {step}")


def _absorb_stream(seed, capacity, front_cap, stage_cap, num_runs, *,
                   masked):
    """Seeds, then a reserved arrival range absorbed a block a boundary
    (the streamed run's shape) under the fence of the next arrival,
    with fresh emits and fenced extracts between boundaries."""
    rng = np.random.default_rng(seed)
    la_np = np.array([0.5, 1.0, 0.0], np.float32)
    la_j, la_t = jnp.asarray(la_np), torch.tensor(la_np)
    qj, qt = _seeded_queue(rng, capacity // 4, capacity, front_cap,
                           stage_cap, num_runs)
    n_arr, block = 48, 12
    seq0 = int(qj.next_seq)
    arr = random_rows(rng, n_arr, t_lo=0, t_hi=12)
    arr[:, 1] = rng.integers(0, 3, n_arr)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    seqs = (seq0 + np.arange(n_arr)).astype(np.int32)
    qj = qj._replace(next_seq=qj.next_seq + n_arr)
    qt = qt._replace(next_seq=qt.next_seq + n_arr)
    cursor = 0
    for step in range(40):
        msg = f"seed {seed} step {step}"
        if step % 5 == 0 and cursor < n_arr:
            # Blocks of 12 rows: two chunks where stage_cap is 8.
            rows, sq = arr[cursor:cursor + block], seqs[cursor:cursor + block]
            # The masked absorb takes rows [2, 9) of the block (the
            # streamed run's [lo, hi) prefix mask).
            idx = np.arange(rows.shape[0])
            ins = (idx >= 2) & (idx < block - 3) if masked else idx >= 0
            qj = _absorb(qj, jnp.asarray(rows), jnp.asarray(sq),
                         jnp.asarray(ins))
            qt = tq.tiered3_queue_absorb_rows(
                qt, torch.tensor(rows), torch.tensor(sq),
                torch.tensor(ins) if masked else None)
            cursor += block
        elif rng.random() < 0.4:
            rows = random_rows(rng, 4, t_lo=step // 4, t_hi=step // 4 + 6)
            qj = _fill(qj, jnp.asarray(rows))
            qt = tq.tiered3_queue_fill_rows(qt, torch.tensor(rows))
        else:
            key = ((float(arr[cursor, 0]), int(seqs[cursor]))
                   if cursor < n_arr else (np.inf, I32_MAX))
            cap = None if rng.random() < 0.7 else float(step)
            qj, tsj, tyj, aj, lj = _extract_bound(
                qj, la_j, None if cap is None else jnp.float32(cap),
                jnp.float32(key[0]), jnp.int32(key[1]))
            qt, tst, tyt, at, lt = tq.tiered3_queue_extract(
                qt, 4, la_t, cap, bound=_bound(*key))
            for g, w in ((tst, tsj), (tyt, tyj), (at, aj), (lt, lj)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=msg)
        assert_queues_equal(qj, qt, msg)
        assert_summaries_equal(qj, qt, msg)
    return qj, qt


ABSORB_CONFIGS = [(64, 8, 8, 2), (96, 6, 16, 1)]


@pytest.mark.parametrize("capacity,front_cap,stage_cap,num_runs",
                         ABSORB_CONFIGS)
@pytest.mark.parametrize("masked", [False, True])
def test_absorb_stream_matches_jax(capacity, front_cap, stage_cap, num_runs,
                                   masked):
    _absorb_stream(7, capacity, front_cap, stage_cap, num_runs,
                   masked=masked)


# ---------------------------------------------------------------------------
# the flat view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
def test_to_flat_matches_jax(seed):
    qj, qt = _absorb_stream(seed, 64, 8, 8, 2, masked=False)
    want = jq.tiered3_queue_to_flat(qj)
    got = tq.tiered3_queue_to_flat(qt)
    for name in ("times", "types", "args", "seqs"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert getattr(got, name).dtype == np.asarray(
            getattr(want, name)).dtype
    for name in ("size", "next_seq", "dropped"):
        assert getattr(got, name) == int(getattr(want, name))
    assert jax_fields(qj)  # the JAX queue stayed readable
