"""Float-to-int32 casts of row columns: ``repro_torch`` against ``repro``.

XLA's convert truncates toward zero, saturates at both ends of int32
and maps NaN to 0; a bare ``.to(torch.int32)`` does not (on the CPU it
gives -2**31 for NaN, ±inf and everything out of range).  The port
casts every f32 row column with ``repro_torch.core.queue.i32_sat``.
Held here: the helper against JAX's ``astype(jnp.int32)``; a tiered3
fill whose type column holds NaN and 3e9, field by field; the sharded
engine's default routing of such ``arg[0]``; and the entity gather and
scatter at saturated ids.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import queue as jq
from repro.core import sharded as jsh
from repro.core.program import _sequential_from_entity as j_seq
from repro_torch.core import queue as tq
from repro_torch.core import sharded as tsh
from repro_torch.core.program import _sequential_from_entity as t_seq

from test_torch_queue_tiered3 import assert_queues_equal

VALUES = np.array([3e9, -3e9, np.nan, 2.5e9, np.inf, -np.inf, 2147483520.0,
                   -2147483648.0, -1.5, 1.5, 2147483648.0, -0.5, 0.0],
                  np.float32)


def test_i32_sat_matches_xla_convert():
    want = np.asarray(jnp.asarray(VALUES).astype(jnp.int32))
    got = tq.i32_sat(torch.from_numpy(VALUES))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want[:6], [2**31 - 1, -2**31, 0, 2**31 - 1, 2**31 - 1, -2**31])


def test_fill_rows_with_nan_and_huge_types_matches_jax():
    """ROADMAP C2's case: four rows of types [0, nan, 3e9, -1] at times
    1-4 into an empty queue; JAX keeps three (NaN is type 0, 3e9 is
    2**31-1)."""
    rows = np.zeros((4, 2 + 4), np.float32)
    rows[:, 0] = [1.0, 2.0, 3.0, 4.0]
    rows[:, 1] = [0.0, np.nan, 3e9, -1.0]
    rows[:, 2] = [5.0, 6.0, 7.0, 8.0]
    kw = dict(front_cap=8, stage_cap=8, num_runs=2)
    qj = jq.tiered3_queue_fill_rows(jq.tiered3_queue_init(64, **kw),
                                    jnp.asarray(rows))
    qt = tq.tiered3_queue_fill_rows(tq.tiered3_queue_init(64, **kw),
                                    torch.from_numpy(rows))
    assert_queues_equal(qj, qt, "nan/3e9 types")
    assert int(qt.size) == 3
    assert qt.f_types[:4].tolist() == [0, 0, 2**31 - 1, -1]


@pytest.mark.parametrize("kind", ["flat", "reference"])
def test_flat_queue_inserts_match_jax(kind):
    rows = np.zeros((4, 2 + 4), np.float32)
    rows[:, 0] = [1.0, 2.0, 3.0, 4.0]
    rows[:, 1] = [np.nan, 3e9, -3e9, 1.0]
    push = ("device_queue_fill_rows" if kind == "flat"
            else "device_queue_push_rows")
    qj = getattr(jq, push)(jq.device_queue_init(8), jnp.asarray(rows))
    qt = getattr(tq, push)(tq.device_queue_init(8), torch.from_numpy(rows))
    for name in qj._fields:
        np.testing.assert_array_equal(getattr(qt, name).numpy(),
                                      np.asarray(getattr(qj, name)),
                                      err_msg=name)


def test_default_routing_saturates_as_jax():
    """``arg[0]`` 3e9 goes to shard 3 at 4 shards, NaN to shard 0."""
    from repro_torch.core.events import EventRegistry as TReg
    from repro.core.events import EventRegistry as JReg

    args = np.zeros((len(VALUES), 4), np.float32)
    args[:, 0] = VALUES
    tys = np.zeros((len(VALUES),), np.int32)
    jr, tr = JReg(), TReg()
    jr.register("a", lambda s, t, a: s)
    tr.register("a", lambda s, t, a: s)
    jeng = jsh.ShardedDeviceEngine(jr, shards=4, capacity=16)
    teng = tsh.ShardedDeviceEngine(tr, shards=4, capacity=16, device="cpu")
    want = np.asarray(jeng._shard_of(jnp.asarray(tys), jnp.asarray(args)))
    got = teng._shard_of(torch.from_numpy(tys), torch.from_numpy(args))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == 3 and want[2] == 0


@pytest.mark.parametrize("eid", [3e9, -3e9, np.nan, -1.0, -5.0, -6.0, 5.0,
                                 2.0])
def test_entity_gather_and_scatter_match_jax(eid):
    """The sequential form of an entity handler at any ``arg[0]``: a
    negative id counts from the end once, the gather clamps, the
    scatter drops an id still out of range."""
    def local(sub, t, arg):
        return {"n": sub["n"] * 3 + 1, "v": sub["v"] + arg[1]}

    state = {"n": np.arange(5, dtype=np.int32) + 1,
             "v": np.arange(10, dtype=np.float32).reshape(5, 2)}
    arg = np.array([eid, 0.5, 0.0, 0.0], np.float32)
    want = j_seq(local, "x")({k: jnp.asarray(v) for k, v in state.items()},
                             jnp.float32(0.0), jnp.asarray(arg))
    got = t_seq(local, "x")({k: torch.from_numpy(v.copy())
                             for k, v in state.items()},
                            torch.tensor(0.0), torch.from_numpy(arg))
    for k in state:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
