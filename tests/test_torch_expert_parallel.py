"""Reduced granite-moe-1b-a400m on a real (1, 4) mesh of 4 gloo
processes on the CPU, its experts split over ``model`` (expert
parallelism), with the sharding rules, the activation anchors and
``seq_parallel=True``, against the same LM without a mesh: a forward, a
prefill, two decode steps and a microbatched, rematerialized train step
(the harness and tolerances of ``tests/test_torch_seq_parallel.py``).
Its 2 x 512 prompt tokens fill one 1024-token dispatch group, so the
forward and prefill route each rank's group to its experts; the train
step's microbatches of 512 tokens take the gathered route.  The same
runs are held to JAX's on a (1, 4) mesh of 4 host devices, as there.
"""

import pytest

from test_torch_seq_parallel import (
    JAX_TOLERANCES,
    TOLERANCES,
    hold_to_jax,
    run_ranks,
)


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    return run_ranks("granite-moe-1b-a400m", tmp_path_factory)


@pytest.mark.parametrize("what,tol", TOLERANCES)
def test_expert_parallel_lm_equals_the_lm_without_a_mesh(errors, what, tol):
    assert errors[what] <= tol, errors


@pytest.mark.parametrize("what,tol", JAX_TOLERANCES)
def test_expert_parallel_lm_equals_jax_on_the_same_mesh(errors, what, tol):
    hold_to_jax(errors, what, tol)


def test_decode_cache_is_sequence_sharded(errors):
    assert errors["seq_sharded_cache"] is True
