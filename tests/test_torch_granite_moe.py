"""The port's LM against the JAX package's on the reduced granite-moe
stack: two ``(gqa, moe)`` layers with tied embeddings, 4 experts top-2.

The configuration, the JAX child process, the inputs and the tolerances
are those of ``tests/test_torch_jamba.py``, whose helpers run here (one
file a configuration keeps each JAX child well under a minute).  The
kernel route's decode is held to JAX's decode with the Pallas decode
kernel.
"""

from __future__ import annotations

import pytest

from test_torch_jamba import (
    IMPLS,
    check_decode,
    check_forward,
    check_prefill,
    check_round_trip,
    gaps,  # noqa: F401  (a fixture)
    jax_refs,
    make_setup,
)

CASES = ("granite",)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return jax_refs(tmp_path_factory, CASES)


@pytest.fixture(scope="module")
def setup(refs):
    return make_setup(refs)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(setup, refs, gaps, case, impl):  # noqa: F811
    check_forward(setup, refs, gaps, case, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_jax(setup, refs, gaps, case, impl):  # noqa: F811
    check_prefill(setup, refs, gaps, case, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_jax(setup, refs, gaps, case, impl):  # noqa: F811
    check_decode(setup, refs, gaps, case, impl)



def test_params_round_trip_granite(setup):
    check_round_trip(setup, "granite")
