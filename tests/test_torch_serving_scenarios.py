"""The admission scenario of ``repro_torch`` against ``repro``'s.

``build_admission_program`` at ``tests/test_serving_scenarios.py``'s
size runs through ``repro``'s device backend and ``repro_torch`` on the
CPU under each dispatch mode (``assert_run_parity``: state, counters,
word histogram, final queue); ``_hash_mod`` is held to JAX's across the
int32 wrap; and the validation errors match.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.program import Config as JConfig
from repro.serving import scenarios as jsc
from repro_torch.api import Config as TConfig
from repro_torch.serving import scenarios as tsc

from test_torch_engine import assert_run_parity

MODES = ("switch", "masked", "fused")


def _kw():
    return dict(num_slots=4, num_requests=24, max_decode=5)


@pytest.mark.parametrize("mode", MODES)
def test_admission_matches_jax(mode):
    jprog = jsc.build_admission_program(
        config=JConfig(max_batch_len=3, capacity=256, max_emit=2), **_kw())
    tprog = tsc.build_admission_program(
        config=TConfig(max_batch_len=3, capacity=256, max_emit=2), **_kw())
    jres = jprog.build(backend="device", dispatch_mode=mode).run(
        jsc.initial_state(4))
    tres = tprog.build(backend="device", device="cpu",
                       dispatch_mode=mode).run(tsc.initial_state(4))
    assert_run_parity(jres, tres)
    state = {k: v.tolist() for k, v in tres.state.items()}
    assert state["arrivals"] == state["admitted"] == state["served"] == 24
    assert state["waiting"] == 0 and state["slots"] == [0, 0, 0, 0]
    assert state["retries"] > 0
    assert all(v.dtype == torch.int32 for v in tres.state.values())
    assert all(tres.state[k].dim() == 0 for k in state if k != "slots")


@pytest.mark.parametrize("salt,mod", [(101, 8), (977, 5), (977, 6),
                                      (0, 7), (3, 1)])
def test_hash_mod_matches_jax_across_the_wrap(salt, mod):
    rng = np.random.default_rng(salt + mod)
    k = np.concatenate([
        np.arange(0, 70_000),
        rng.integers(-2**31, 2**31 - 1 - salt, 2000),
        # (k + salt) * 1103515245 == -2**31: abs stays -2**31.
        [2**31 - salt - 1, 2**31 - 1 - salt - 1],
        [-2**31, -2**31 + 1, -1],
    ]).astype(np.int32)
    want = np.asarray(jsc._hash_mod(jnp.asarray(k), salt, mod))
    got = tsc._hash_mod(torch.from_numpy(k), salt, mod)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all() and (got < mod).all()


def test_abs_of_int_min_wraps_as_jax():
    t = torch.abs(torch.tensor(-2**31, dtype=torch.int32)) % 7
    j = jnp.abs(jnp.int32(-2**31)) % jnp.int32(7)
    assert int(t) == int(j) == 5
    # (k + 101) wraps to -2**31 at k = 2**31 - 101.
    k = 2**31 - 101
    assert int(tsc._hash_mod(torch.tensor(k, dtype=torch.int32), 101, 7)) \
        == int(jsc._hash_mod(jnp.int32(k), 101, 7)) == 5


def test_validation_errors_match():
    for pkg, cfg in ((jsc, JConfig), (tsc, TConfig)):
        with pytest.raises(ValueError, match="arrival_lookahead must be "
                                             "exactly 0.25"):
            pkg.build_admission_program(arrival_lookahead=0.5)
        with pytest.raises(ValueError, match="max_emit >= 2"):
            pkg.build_admission_program(config=cfg(max_emit=1))
    for pkg, cfg in ((jsc, JConfig), (tsc, TConfig)):
        with pytest.raises(ValueError, match="max_emit >= 2"):
            pkg.build_open_admission_program(config=cfg(max_emit=1))
    prog = tsc.make_open_program()
    assert prog.name == "serving-admission-open"
    assert prog._entries == {"ARRIVE"}
    assert set(prog._example_state) == set(tsc.initial_state(4))


def test_make_program_declares_its_state():
    prog = tsc.make_program()
    assert prog.name == "serving-admission"
    assert set(prog._example_state) == set(tsc.initial_state(4))
    res = prog.build(device="cpu", dispatch_mode="masked").run(
        tsc.initial_state(4))
    assert int(res.state["served"]) == 16
