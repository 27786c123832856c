"""Events and codec of ``repro_torch`` against ``repro``.

``DenseCodec.encode``/``decode`` must agree with ``repro.core.codec``
for every word of every small alphabet, and the on-device
``encode_torch`` with ``encode_jnp`` for every padded window (exact:
integer arithmetic).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import codec as jcodec
from repro.core import events as jevents
from repro_torch.core import codec as tcodec
from repro_torch.core import events as tevents


@pytest.mark.parametrize("T,k", [(1, 1), (1, 4), (2, 3), (3, 2), (3, 4),
                                 (2, 4)])
def test_dense_codec_matches_reference(T, k):
    jc, tc = jcodec.DenseCodec(T, k), tcodec.DenseCodec(T, k)
    assert tc.num_batches == jc.num_batches
    assert list(tc.enumerate_words()) == list(jc.enumerate_words())
    for n in range(1, k + 1):
        for word in itertools.product(range(T), repeat=n):
            code = jc.encode(list(word))
            assert tc.encode(list(word)) == code
            assert tc.decode(code) == jc.decode(code) == list(word)
            padded = list(word) + [0] * (k - n)
            want = int(jc.encode_jnp(jnp.asarray(padded, jnp.int32),
                                     jnp.int32(n)))
            got = tc.encode_torch(torch.tensor(padded, dtype=torch.int32),
                                  torch.tensor(n, dtype=torch.int32))
            assert got.dtype == torch.int32
            assert int(got) == want == code


def test_encode_torch_empty_window_matches_encode_jnp():
    jc, tc = jcodec.DenseCodec(3, 4), tcodec.DenseCodec(3, 4)
    want = int(jc.encode_jnp(jnp.zeros((4,), jnp.int32), jnp.int32(0)))
    got = int(tc.encode_torch(torch.zeros(4, dtype=torch.int32),
                              torch.tensor(0, dtype=torch.int32)))
    assert got == want == 0


def test_codec_rejects_out_of_range():
    tc = tcodec.DenseCodec(2, 3)
    with pytest.raises(ValueError):
        tc.encode([0, 2])
    with pytest.raises(ValueError):
        tc.encode([])
    with pytest.raises(ValueError):
        tc.decode(tc.num_batches)
    assert tcodec.make_codec("paper", 2, 3) == tcodec.PaperCodec(2, 3)
    with pytest.raises(ValueError, match="unknown codec"):
        tcodec.make_codec("bogus", 2, 3)
    assert tcodec.make_codec("dense", 2, 3) == tc


def test_registry_matches_reference():
    jr, tr = jevents.EventRegistry(), tevents.EventRegistry()
    for reg in (jr, tr):
        reg.register("a", lambda s, t, a: s, lookahead=0.5)
        reg.register("b", lambda s, t, a: (s, []), lookahead=float("inf"))
        reg.register("c", tevents.emits_events(lambda s, t, a: (s, [])))
        reg.freeze()
    assert tr.names == jr.names
    np.testing.assert_array_equal(tr.lookaheads("cpu").numpy(),
                                  np.asarray(jr.lookaheads()))
    assert [t.returns_events for t in tr] == [False, False, True]
    assert tr["c"].type_id == 2
    with pytest.raises(RuntimeError):
        tr.register("d", lambda s, t, a: s)
    assert tevents.ARG_WIDTH == jevents.ARG_WIDTH
    assert tevents.normalize_handler_result(1, returns_events=False) == (1, [])
    assert tevents.normalize_handler_result(
        (1, ((0.5, 0, None),)), returns_events=True) == (1, [(0.5, 0, None)])
