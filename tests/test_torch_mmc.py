"""The M/M/c network of ``repro_torch`` against ``examples/mmc_network.py``.

The same program runs through ``repro``'s device backend and through
``repro_torch`` on the CPU under each dispatch mode, held with the
``tests/_parity.py`` assertion set plus the word histogram and every
field of the final queue (``assert_run_parity``).  Tolerance: exact.

Three stations at ``t_open`` 12.0 (the size of
``tests/test_simprogram_parity.py``) run against JAX's ``device/
tiered3``, ``device/masked`` and ``device/fused``.  The example's own
four stations (``max_batch_len`` 4, 120 words) run each port mode
against JAX's ``masked``: JAX's ``switch`` compiles 120 branches there
(about 40 s on one core) and its ``fused`` 32 (about 10 s), and JAX's
own parity tests pin both to ``masked``.
"""

import sys

import numpy as np
import pytest

from repro_torch.core import queue as tq
from repro_torch.examples import mmc_network as tmmc

from test_torch_engine import ROOT, assert_run_parity

sys.path.insert(0, str(ROOT / "examples"))
import mmc_network as jmmc  # noqa: E402  (examples/ is not a package)

MODES = ("switch", "masked", "fused")
_JAX_RUNS = {}


def _jax_run(K, t_open, mode):
    key = (K, t_open, mode)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = jmmc.build_program(
            num_stations=K, t_open=t_open).build(
                backend="device", dispatch_mode=mode).run(
                    jmmc.initial_state(K))
    return _JAX_RUNS[key]


def _torch_run(K, t_open, mode):
    tq.COUNTS.clear()
    res = tmmc.build_program(num_stations=K, t_open=t_open).build(
        backend="device", device="cpu", dispatch_mode=mode).run(
            tmmc.initial_state(K))
    return res, dict(tq.COUNTS)


def _check_model(res):
    st = {k: v.numpy() for k, v in res.state.items()}
    assert st["samples"].sum() > 0 and st["served"].sum() > 0
    np.testing.assert_array_equal(st["arrived"],
                                  st["served"] + st["qlen"] + st["busy"])


@pytest.mark.parametrize("mode", MODES)
def test_mmc_three_stations_matches_jax(mode):
    jres = _jax_run(3, 12.0, mode)
    tres, counts = _torch_run(3, 12.0, mode)
    assert_run_parity(jres, tres)
    _check_model(tres)
    assert counts["run_path"] > 0          # TALLY ran as one vmap
    if mode == "fused":
        # Three types, max_batch_len 3: 39 words, the first 32 hot;
        # every window takes one of the three routes.
        assert counts["fused_hot"] + counts["fused_fallback"] + \
            counts["run_path"] == tres.batches


@pytest.mark.parametrize("mode", MODES)
def test_mmc_four_stations_matches_jax(mode):
    jres = _jax_run(4, 30.0, "masked")
    tres, counts = _torch_run(4, 30.0, mode)
    assert_run_parity(jres, tres)
    _check_model(tres)
    assert counts["run_path"] > 0
    if mode == "fused":
        assert counts["fused_hot"] > 0 and counts["fused_fallback"] > 0
