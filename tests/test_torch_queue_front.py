"""The front-tier kernels' plain versions against ``repro``.

``window_extract`` is held against ``repro``'s XLA extract path
(``window_prefix_mask`` + ``tiered3_queue_pop_prefix``), which the
Pallas kernel is bit-identical to by contract; the Pallas
``window_extract`` itself does not run on this JAX version.
``front_merge`` is held against the Pallas kernel in interpret mode and
against the XLA fill.  Tolerance: exact — every operation on this path
is an f32 compare, an f32 add, a gather or integer counting.  The CUDA
kernels are held against these same plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import queue as jq
from repro.core.events import ARG_WIDTH
from repro.kernels import queue_front as jkf
from repro_torch.core import queue as tq
from repro_torch.kernels import queue_front as tkf

I32_MAX = 2**31 - 1
W = ARG_WIDTH


def sorted_front(rng, F, front_n, *, t_hi=8, num_types=3, width=W):
    """A front tier: ``front_n`` live slots sorted by (time, seq) with
    heavy time ties (all tied with ``t_hi=1``), sentinels after."""
    t = np.sort(rng.integers(0, t_hi, front_n) * 0.5).astype(np.float32)
    ft = np.full((F,), np.inf, np.float32)
    fy = np.full((F,), -1, np.int32)
    fa = np.zeros((F, width), np.float32)
    fs = np.full((F,), I32_MAX, np.int32)
    ft[:front_n] = t
    fy[:front_n] = rng.integers(0, num_types, front_n)
    fa[:front_n] = rng.random((front_n, width))
    fs[:front_n] = np.arange(front_n)
    return ft, fy, fa, fs


def jax_extract_reference(cols, front_n, la, t_cap, k):
    """repro's XLA extract path after the refill."""
    ft, fy, fa, fs = (jnp.asarray(c) for c in cols)
    F = ft.shape[0]
    q = jq.tiered3_queue_init(F + 8, front_cap=F, stage_cap=8, num_runs=1)
    q = q._replace(f_times=ft, f_types=fy, f_args=fa, f_seqs=fs,
                   front_n=jnp.int32(front_n), size=jnp.int32(front_n))
    la = jnp.asarray(la)
    valid = fy[:k] >= 0
    wins = jnp.where(valid, ft[:k] + la[jnp.clip(fy[:k], 0, la.shape[0] - 1)],
                     jnp.inf)
    take = jq.window_prefix_mask(ft[:k], wins, valid, t_cap)
    length = jnp.sum(take).astype(jnp.int32)
    q = jq.tiered3_queue_pop_prefix(q, length, k)
    return (jnp.where(take, ft[:k], 0.0), jnp.where(take, fy[:k], 0),
            jnp.where(take[:, None], fa[:k], 0.0), length,
            q.f_times, q.f_types, q.f_args, q.f_seqs)


@pytest.mark.parametrize("F,k", [(16, 4), (256, 4), (256, 16)])
@pytest.mark.parametrize("case", ["random", "ties", "partial", "empty",
                                  "cap", "inf_lookahead"])
def test_window_extract_plain_matches_xla_path(F, k, case):
    rng = np.random.default_rng(F * 100 + k)
    front_n = {"partial": k // 2, "empty": 0}.get(case, F)
    t_hi = 2 if case == "ties" else 8
    cols = sorted_front(rng, F, front_n, t_hi=t_hi)
    la = np.asarray([0.5, 1.0, 0.0], np.float32)
    if case == "inf_lookahead":
        la = np.asarray([np.inf, np.inf, np.inf], np.float32)
    t_cap = 1.5 if case == "cap" else None
    want = jax_extract_reference(cols, front_n, la, t_cap, k)
    got = tkf.window_extract(*(torch.tensor(c) for c in cols),
                             torch.tensor(la), t_cap, k=k)
    assert tkf.LAUNCHES["window_extract"] == 0   # CPU takes the plain path
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def merge_inputs(rng, F, R, front_n, mask, *, t_hi=(8, 10), width=W):
    cols = sorted_front(rng, F, front_n, t_hi=t_hi[0], width=width)
    t_r = (rng.integers(0, t_hi[1], R) * 0.5).astype(np.float32)
    ty_r = rng.integers(0, 3, R).astype(np.int32)
    arg_r = rng.random((R, width)).astype(np.float32)
    seq_r = (1000 + rng.permutation(R)).astype(np.int32)
    to_front = {"none": np.zeros(R, bool), "all": np.ones(R, bool)}.get(
        mask, rng.random(R) < 0.6)
    return (*cols, np.int32(front_n), t_r, ty_r, arg_r, seq_r, to_front)


@pytest.mark.parametrize("F,R", [(16, 4), (256, 4), (256, 32)])
@pytest.mark.parametrize("mask,fill", [("random", "full"), ("random", "half"),
                                       ("none", "half"), ("all", "empty"),
                                       ("all", "full")])
def test_front_merge_plain_matches_pallas_interpret(F, R, mask, fill):
    rng = np.random.default_rng(F + R)
    front_n = {"full": F, "half": F // 2, "empty": 0}[fill]
    inputs = merge_inputs(rng, F, R, front_n, mask)
    want = jkf.front_merge(*(jnp.asarray(x) for x in inputs),
                           interpret=True)
    got = tkf.front_merge(*(torch.tensor(x) for x in inputs))
    assert tkf.LAUNCHES["front_merge"] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(4))
def test_fill_rows_matches_xla_fill(seed):
    """The port's fill (accounting + front_merge + staging) against the
    XLA ``tiered3_queue_fill_rows`` at the engine's default widths."""
    rng = np.random.default_rng(seed)
    F, R = 256, 8
    events = [(float(rng.integers(0, 40)) * 0.5, int(rng.integers(0, 3)),
               rng.random(W).astype(np.float32)) for _ in range(300)]
    qj = jq.tiered3_queue_from_host(events, 1024, front_cap=F)
    qt = tq.tiered3_queue_from_host(events, 1024, front_cap=F)
    fill = jax.jit(jq.tiered3_queue_fill_rows)
    for step in range(5):
        rows = np.zeros((R, 2 + W), np.float32)
        rows[:, 0] = rng.integers(0, 60, R) * 0.5
        rows[:, 1] = rng.integers(-1, 3, R)
        rows[:, 2:] = rng.random((R, W))
        qj = fill(qj, jnp.asarray(rows))
        qt = tq.tiered3_queue_fill_rows(qt, torch.tensor(rows))
        got = tq.tiered3_queue_to_arrays(qt)
        for name in qj._fields:
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(qj, name)),
                err_msg=f"step {step} field {name}")


def test_wrappers_reject_other_devices():
    """The wrapper routes by device: CPU -> plain version, CUDA ->
    kernel; there is no other route."""
    cols = sorted_front(np.random.default_rng(0), 8, 8)
    meta = [torch.tensor(c, device="meta") for c in cols]
    with pytest.raises(ValueError, match="no queue_front kernel"):
        tkf.window_extract(*meta, torch.zeros(1, device="meta"), k=2)


# ---------------------------------------------------------------------------
# the edges of the CUDA designs: R around one warp of rows, F off a warp,
# narrow arg rows, all-tie fronts, front_n at 0 and at F
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("F,k,width", [(40, 32, 1), (100, 7, 3), (40, 4, 3),
                                       (100, 32, 1)])
@pytest.mark.parametrize("case", ["all_ties", "empty", "full", "cap"])
def test_window_extract_plain_at_kernel_edges(F, k, width, case):
    rng = np.random.default_rng(F * 7 + k * 3 + width)
    front_n = 0 if case == "empty" else F
    cols = sorted_front(rng, F, front_n, t_hi=1 if case == "all_ties" else 4,
                        width=width)
    la = np.asarray([0.5, 0.0, 1.0], np.float32)
    t_cap = 0.5 if case == "cap" else None
    want = jax_extract_reference(cols, front_n, la, t_cap, k)
    got = tkf.window_extract(*(torch.tensor(c) for c in cols),
                             torch.tensor(la), t_cap, k=k)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("F,R,width", [(40, 1, 1), (100, 31, 3), (40, 32, 1),
                                       (100, 33, 3), (40, 64, 1),
                                       (100, 64, 3)])
@pytest.mark.parametrize("fill,ties", [("full", "all"), ("empty", "all"),
                                       ("full", "some"), ("empty", "some")])
def test_front_merge_plain_at_kernel_edges(F, R, width, fill, ties):
    rng = np.random.default_rng(F * 5 + R)
    front_n = F if fill == "full" else 0
    inputs = merge_inputs(rng, F, R, front_n, "random",
                          t_hi=(1, 1) if ties == "all" else (4, 6),
                          width=width)
    want = jkf.front_merge(*(jnp.asarray(x) for x in inputs),
                           interpret=True)
    got = tkf.front_merge(*(torch.tensor(x) for x in inputs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the CUDA wrappers' plan cache (the plans are built on CPU tensors here;
# the launch itself needs the card)
# ---------------------------------------------------------------------------

def _window_operands(F=16, width=W):
    cols = sorted_front(np.random.default_rng(1), F, F, width=width)
    return [torch.tensor(c) for c in cols] + [torch.tensor([0.5, 1.0])]


def test_window_plan_is_built_once_per_signature():
    ops = _window_operands()
    first = tkf.window_extract_plan(*ops, None, k=4)
    assert tkf.window_extract_plan(*ops, None, k=4) is first
    again = [t.clone() for t in ops]                 # new data, same layout
    assert tkf.window_extract_plan(*again, None, k=4) is first
    assert first[1] == (2, float("inf"), 16, W, 4)
    # A changed signature is planned, and checked, anew.
    wider = tkf.window_extract_plan(*_window_operands(40), None, k=4)
    assert wider is not first and wider[1][2] == 40
    capped = tkf.window_extract_plan(*ops, 2.5, k=4)
    assert capped is not first and capped[1][1] == 2.5
    assert tkf.window_extract_plan(*ops, None, k=3)[1][4] == 3


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "k", "t_cap"])
def test_window_plan_rejects_bad_operands_after_a_cached_call(bad):
    ops = _window_operands()
    tkf.window_extract_plan(*ops, None, k=4)
    k, t_cap = 4, None
    if bad == "dtype":
        ops[3] = ops[3].float()
    elif bad == "shape":
        ops[3] = ops[3][:8].contiguous()
    elif bad == "contiguous":
        ops[2] = torch.zeros((W, 16)).t()
    elif bad == "k":
        k = 33
    else:
        t_cap = torch.tensor(1.0)
    with pytest.raises((TypeError, ValueError)):
        tkf.window_extract_plan(*ops, t_cap, k=k)


def _merge_operands(F=16, R=4):
    return [torch.tensor(x) for x in merge_inputs(
        np.random.default_rng(2), F, R, F, "random")]


def test_merge_plan_is_built_once_per_signature():
    ops = _merge_operands()
    first = tkf.front_merge_plan(*ops)
    assert tkf.front_merge_plan(*[t.clone() for t in ops]) is first
    assert first[1] == (16, 4, W)
    other = tkf.front_merge_plan(*_merge_operands(R=33))
    assert other is not first and other[1] == (16, 33, W)


@pytest.mark.parametrize("bad", ["dtype", "rows", "mask", "front_n"])
def test_merge_plan_rejects_bad_operands_after_a_cached_call(bad):
    ops = _merge_operands()
    tkf.front_merge_plan(*ops)
    if bad == "dtype":
        ops[5] = ops[5].double()
    elif bad == "rows":
        ops[7] = ops[7][:3].contiguous()
    elif bad == "mask":
        ops[9] = ops[9].to(torch.int32)
    else:
        ops[4] = ops[4].reshape(1)
    with pytest.raises((TypeError, ValueError)):
        tkf.front_merge_plan(*ops)
