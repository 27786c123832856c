"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on ONE set of weights: the JAX
``moe_init`` pytree carried across as tensors.  Activations are
numpy-seeded bf16 values.

What must be equal: the routed expert indices, the drop pattern (which
(token, expert) pairs fall past the per-group capacity) and the aux loss
(within 1e-6 relative: the softmax means sum in another order).  ``y``
agrees within the bf16 tolerance of ``tests/test_torch_lm.py`` (two
bf16 ulps of the value): the expert products round their bf16 outputs in
both packages, but a sum may land on the neighbouring bf16 value.

Routing is a discontinuous function of the router logits, so each case
prints the smallest gap between the k-th and the (k+1)-th logit of a
token and asserts it is far above the f32 rounding of the router product
(1e-7 relative): the equality checks are then decidable, and a routing
difference could not hide behind a near tie.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from repro_torch.models.model import ParamTree, _leaves, _to_tensor

BF16_TOL = dict(rtol=2.0**-6, atol=2.0**-6)
MIN_GAP = 1e-4
D, F = 32, 48


@functools.lru_cache(maxsize=None)
def _jax_params(E, num_shared=0, activation="swiglu", seed=0):
    return jmoe.moe_init(jax.random.PRNGKey(seed), d_model=D, d_ff_expert=F,
                         num_experts=E, num_shared=num_shared,
                         activation=activation)


def _torch_params(jparams, E, num_shared=0, activation="swiglu"):
    """The JAX pytree as the port's nested parameters."""
    tree = ParamTree(tmoe.moe_weight_shapes(
        d_model=D, d_ff_expert=F, num_experts=E, num_shared=num_shared,
        activation=activation), "cpu")
    tree.load_state_dict({path: _to_tensor(np.asarray(a))
                          for path, a in _leaves(jparams)})
    return tree


def _x(seed, B, T):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((B, T, D)), jnp.float32).astype(
        jnp.bfloat16)
    return x, _to_tensor(np.asarray(x))


def _np(t):
    return t.float().numpy()


def _gap(logits, k):
    """Smallest gap between a token's k-th and (k+1)-th router logit."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., ::-1]
    return float(np.min(top[..., k - 1] - top[..., k]))


def _jax_routing(jparams, x, E, K, cf, group_size):
    """The routing lines of ``repro.models.moe.moe_apply`` (which returns
    only y and aux): the router logits, the top-k indices and the kept
    mask of each (token, expert) pair."""
    B, T, _ = x.shape
    N = B * T
    n = min(group_size, N)
    if N % n:
        n = T if N % T == 0 else N
    xg = x.reshape(N // n, n, D)
    C = max(1, int(np.ceil(n * K / E * cf)))
    logits = jnp.einsum("gnd,de->gne", xg.astype(jnp.float32),
                        jparams["router"])
    _, idx = jax.lax.top_k(logits, K)
    mask = jax.nn.one_hot(idx, E, dtype=jnp.float32).sum(axis=-2)
    pos = jnp.cumsum(mask, axis=1) * mask - 1.0
    kept = (pos < C) & (pos >= 0)
    return np.asarray(logits), np.asarray(idx), np.asarray(kept), \
        np.asarray(mask), C, n


def _torch_routing(tparams, x, K, C, n):
    """The same quantities from the port's ``moe_apply`` routing
    (``_dispatch``), for groups of ``n`` tokens at capacity ``C``."""
    xg = x.reshape(-1, n, D)
    logits = tmoe.proj(xg.float(), tparams["router"])
    dispatch, _, _, idx = tmoe._dispatch(logits, K, C)
    return logits.numpy(), idx.numpy(), (dispatch.sum(-1) > 0).numpy()


# (B, T, E, K, capacity_factor, group_size): one group; several groups;
# the one-group-per-sequence fallback (N % group_size != 0); a capacity
# that drops tokens (cf 1.25, 8 experts top-2); the reduced configs'
# dropless cf = E/K.
CASES = [(2, 12, 4, 2, 2.0, 1024), (4, 8, 4, 2, 1.25, 8),
         (2, 12, 4, 2, 1.25, 16), (1, 32, 8, 2, 1.25, 1024),
         (3, 16, 8, 2, 1.25, 16)]


@pytest.mark.parametrize("B,T,E,K,cf,gs", CASES)
def test_moe_apply_matches_jax(B, T, E, K, cf, gs):
    jp = _jax_params(E)
    tp = _torch_params(jp, E)
    x, tx = _x(B * 100 + T, B, T)
    jl, jidx, jkept, jmask, C, n = _jax_routing(jp, x, E, K, cf, gs)
    tl, tidx, tkept = _torch_routing(tp, tx, K, C, n)
    gap = _gap(jl, K)
    print(f"B{B} T{T} E{E} K{K} cf{cf} group {gs}: capacity {C}, "
          f"smallest k-th/(k+1)-th logit gap {gap:.3g}, "
          f"dropped {int(jmask.sum() - jkept.sum())} of {int(jmask.sum())}")
    assert gap > MIN_GAP
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkept, jkept)

    jy, jaux = jax.jit(functools.partial(
        jmoe.moe_apply, num_experts=E, top_k=K, capacity_factor=cf,
        group_size=gs))(jp, x)
    ty, taux = tmoe.moe_apply(tp, tx, num_experts=E, top_k=K,
                              capacity_factor=cf, group_size=gs)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == (B, T, D)
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32),
                               **BF16_TOL)
    # a token dropped by every expert it chose contributes nothing
    gone = ~jkept.reshape(B * T, E).any(axis=-1)
    assert np.all(_np(ty).reshape(B * T, D)[gone] == 0)


def test_capacity_factor_1_25_drops_tokens():
    """8 experts top-2 over 32 tokens: capacity ceil(32*2/8*1.25) = 10,
    and the random router sends more than that to some expert."""
    B, T, E, K, cf, gs = 1, 32, 8, 2, 1.25, 1024
    jp = _jax_params(E)
    x, _ = _x(B * 100 + T, B, T)
    _, _, kept, mask, C, _ = _jax_routing(jp, x, E, K, cf, gs)
    assert C == 10
    assert kept.sum() < mask.sum()


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("num_shared", [0, 1])
def test_moe_apply_dense_matches_jax(activation, num_shared):
    """Dropless: every expert on every token; the top-k weights equal."""
    E, K = 4, 2
    jp = _jax_params(E, num_shared, activation)
    tp = _torch_params(jp, E, num_shared, activation)
    x, tx = _x(9, 4, 1)
    jl = np.asarray(jnp.einsum("td,de->te",
                               x.reshape(4, D).astype(jnp.float32),
                               jp["router"]))
    gap = _gap(jl, K)
    print(f"dense {activation} shared {num_shared}: smallest gap {gap:.3g}")
    assert gap > MIN_GAP
    jy = jax.jit(functools.partial(
        jmoe.moe_apply_dense, num_experts=E, top_k=K,
        activation=activation))(jp, x)
    ty = tmoe.moe_apply_dense(tp, tx, num_experts=E, top_k=K,
                              activation=activation)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == (4, 1, D)
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32),
                               **BF16_TOL)
    jw, _ = jmoe._top_k_mask(jnp.asarray(jl), K)
    tw, _ = tmoe._top_k_mask(torch.from_numpy(jl.copy()), K)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def test_top_k_breaks_ties_toward_the_lower_index():
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 0.0, 5.0, -1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 3)
    tv, ti = tmoe._top_k(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jw, jm = jmoe._top_k_mask(jnp.asarray(logits), 2)
    tw, tm = tmoe._top_k_mask(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)


def test_moe_init_matches_the_jax_rule():
    """``moe_init`` draws other numbers than JAX, but by the same rule:
    f32 router and bf16 expert stacks at the JAX scales."""
    E = 4
    shapes = tmoe.moe_weight_shapes(d_model=D, d_ff_expert=F, num_experts=E)
    tp = ParamTree(shapes, "cpu")
    tmoe.moe_init(torch.Generator().manual_seed(0), tp, d_model=D,
                  d_ff_expert=F, num_experts=E)
    jp = _jax_params(E)
    assert tp["router"].dtype == torch.float32
    assert tuple(tp["experts"]["gate"].shape) == (E, D, F)
    assert tuple(tp["experts"]["down"].shape) == (E, F, D)
    for path, a in _leaves(jp):
        got = dict(_leaves({"router": tp["router"],
                            "experts": dict(tp["experts"].named_parameters())
                            }))[path]
        assert tuple(got.shape) == np.asarray(a).shape, path
        want = float(np.std(np.asarray(a, np.float32)))
        assert 0.8 * want < float(got.float().std()) < 1.2 * want, path
    # each expert is its own draw
    g = tp["experts"]["gate"]
    assert not torch.equal(g[0], g[1])
