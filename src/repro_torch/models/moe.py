"""Mixture-of-Experts: top-k router + capacity-based one-hot dispatch
(PyTorch port of :mod:`repro.models.moe`).

Parameters keep the JAX layout: an f32 router ``[D, E]`` and the experts
as stacked MLPs, ``gate``/``up`` ``[E, D, F]`` and ``down`` ``[E, F, D]``
in bf16 (plus an optional ``shared`` MLP).  Two entry points:

* :func:`moe_apply` — GShard grouped dispatch with a per-group capacity
  ``C = ceil(n·k/E · capacity_factor)``: tokens past an expert's capacity
  are dropped, as in JAX.  Returns the Switch load-balancing aux loss.
* :func:`moe_apply_dense` — dropless: every expert on every token, the
  top-k weights combine.  Decode uses it.

The expert products are batched matrix products over the expert axis
(``torch.bmm``), as JAX leaves them to XLA einsums; no kernel of this
repository runs here.  Roundings follow JAX's: the router runs in f32;
the dispatch products have no ``preferred_element_type`` there, so their
outputs are rounded to the activation dtype before the cast to f32; the
dense path's expert MLPs accumulate in f32, as ``mlp_apply`` does.
Top-k ties go to the lower expert index, as ``lax.top_k``'s do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models import shards as sh
from repro_torch.models.layers import (
    DEFAULT_DTYPE,
    dense_init,
    mlp_apply,
    mlp_weight_shapes,
    proj,
)


def moe_weight_shapes(*, d_model: int, d_ff_expert: int, num_experts: int,
                      num_shared: int = 0, activation: str = "swiglu") -> dict:
    """Nested name -> (shape, dtype) of a MoE FFN's weights."""
    E = num_experts
    shapes = {
        "router": ((d_model, E), torch.float32),
        "experts": {name: ((E, *shape), DEFAULT_DTYPE)
                    for name, shape in mlp_weight_shapes(
                        d_model, d_ff_expert, activation).items()},
    }
    if num_shared:
        shapes["shared"] = {name: (shape, DEFAULT_DTYPE)
                            for name, shape in mlp_weight_shapes(
                                d_model, d_ff_expert * num_shared,
                                activation).items()}
    return shapes


@torch.no_grad()
def moe_init(gen: torch.Generator, p, *, d_model: int, d_ff_expert: int,
             num_experts: int, num_shared: int = 0,
             activation: str = "swiglu"):
    """Fill ``p`` (a nested dict-like of :func:`moe_weight_shapes`) in
    place with fan-in truncated-normal weights, as the JAX ``moe_init``:
    each expert slice on its own, so no ``[E, D, F]`` f32 temporary is
    made."""
    for e in range(num_experts):
        for name, (fan_in, fan_out) in mlp_weight_shapes(
                d_model, d_ff_expert, activation).items():
            dense_init(gen, fan_in, fan_out, out=p["experts"][name][e])
    dense_init(gen, d_model, num_experts, out=p["router"])
    if num_shared:
        for name, (fan_in, fan_out) in mlp_weight_shapes(
                d_model, d_ff_expert * num_shared, activation).items():
            dense_init(gen, fan_in, fan_out, out=p["shared"][name])


def _top_k(logits, k):
    """The k largest logits along the last dim and their indices, ties to
    the lower index (a stable descending sort), as ``lax.top_k``."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_mask(logits, k):
    """[T,E] f32 -> (weights [T,E] renormalized over the top-k, mask
    [T,E])."""
    vals, idx = _top_k(logits, k)
    oh = F.one_hot(idx, logits.shape[-1]).float()           # [T,k,E]
    mask = oh.sum(dim=-2)
    probs = torch.softmax(vals, dim=-1)                      # renorm top-k
    weights = torch.einsum("tk,tke->te", probs, oh)
    return weights, mask


def _expert_mm(x, w):
    """``x [E,M,K] @ w [E,K,F]`` per expert, rounded once to x's dtype:
    JAX's dispatch einsums, which have no ``preferred_element_type``."""
    if x.is_cuda:
        return torch.bmm(x, w)    # f32 accumulation, one rounding
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def _expert_mm_f32(x, w):
    """``x [E,M,K] @ w [E,K,F]`` per expert, accumulated and returned in
    f32 (``proj`` for a stack of experts)."""
    if not x.is_cuda:
        return torch.bmm(x.float(), w.float())
    if x.dtype == w.dtype == torch.float32:
        return torch.bmm(x, w)
    return torch.bmm(x, w, out_dtype=torch.float32)


def _balance(logits, mask):
    """The Switch loss's per-expert means over the tokens: the share
    routed to each expert, ``f`` [E], and its mean router probability,
    ``p`` [E]."""
    return (torch.mean(mask, dim=(0, 1)),
            torch.mean(torch.softmax(logits, dim=-1), dim=(0, 1)))


def _dispatch(logits, top_k: int, capacity: int):
    """Router logits [G,n,E] f32 -> (dispatch [G,n,E,C] one-hot of each
    kept (token, expert) pair's buffer position, combine [G,n,E,C]: the
    dispatch weighted by the renormalized top-k probabilities, the Switch
    loss's means ``(f, p)`` (:func:`_balance`; the loss is ``E * sum(f *
    p)``), the top-k expert indices [G,n,K]).  A token whose position
    in its expert's group buffer reaches ``capacity`` is dropped from
    that expert."""
    E = logits.shape[-1]
    vals, idx = _top_k(logits, top_k)                        # [G,n,K]
    probs = torch.softmax(vals, dim=-1)
    oh = F.one_hot(idx, E).float()                           # [G,n,K,E]
    weights = torch.einsum("gnk,gnke->gne", probs, oh)
    mask = oh.sum(dim=-2)                                    # [G,n,E]


    # Position of each token within its expert's per-group buffer.
    pos = torch.cumsum(mask, dim=1) * mask - 1.0             # [G,n,E]
    in_cap = (pos < capacity) & (pos >= 0)
    pos_oh = F.one_hot(pos.clamp(0, capacity - 1).long(), capacity).float()
    dispatch = pos_oh * in_cap[..., None]                    # [G,n,E,C]
    return (dispatch, dispatch * weights[..., None], _balance(logits, mask),
            idx)


def moe_apply(params, x, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, activation: str = "swiglu",
              group_size: int = 1024):
    """x: [B,T,D] -> (y [B,T,D], aux_loss f32 scalar).

    Grouped GShard dispatch: tokens are split into groups of
    ``group_size`` (one group per sequence, or one in all, when that does
    not divide ``B*T``), and capacity applies per group.  A token whose
    position in its expert's buffer reaches the capacity is dropped from
    that expert."""
    B, T, D = x.shape
    E, K = num_experts, top_k
    N = B * T
    n = min(group_size, N)
    if N % n:  # fall back to one group per sequence
        n = T if N % T == 0 else N
    capacity = max(1, int(math.ceil(n * K / E * capacity_factor)))
    if isinstance(x, DTensor):
        y, aux = _moe_shards(params, x, n=n, capacity=capacity,
                             num_experts=E, top_k=K, activation=activation)
    else:
        y, f, p = _moe_routed(x, params["router"], params["experts"], n=n,
                              capacity=capacity, top_k=K,
                              activation=activation)
        aux = E * torch.sum(f * p)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, activation=activation)
    return y, aux


def _moe_routed(x, router, experts, *, n: int, capacity: int, top_k: int,
                activation: str, expert0: int = 0):
    """The routed experts on x [B,T,D] in groups of ``n`` tokens: ->
    (y [B,T,D], the balance means ``f``, ``p`` [E]).  ``experts`` may
    hold a slice of the E experts, starting at ``expert0``: y then sums
    that slice's outputs alone."""
    B, T, D = x.shape
    G = B * T // n
    xg = x.reshape(G, n, D)
    logits = proj(xg.float(), router)                        # f32 [G,n,E]
    dispatch, combine, (f, p), _ = _dispatch(logits, top_k, capacity)
    E_l = experts["down"].shape[0]
    if E_l != logits.shape[-1]:
        dispatch = dispatch[:, :, expert0:expert0 + E_l]
        combine = combine[:, :, expert0:expert0 + E_l]
    xe = torch.einsum("gnd,gnec->egcd", xg.float(), dispatch).to(x.dtype)
    xe = xe.reshape(E_l, G * capacity, D)                    # [E,G*C,D]
    if activation in ("swiglu", "geglu"):
        gph = _expert_mm(xe, experts["gate"]).float()
        uph = _expert_mm(xe, experts["up"]).float()
        act = F.silu(gph) if activation == "swiglu" else \
            F.gelu(gph, approximate="tanh")
        he = (act * uph).to(x.dtype)
    else:
        uph = _expert_mm(xe, experts["up"]).float()
        he = (F.gelu(uph, approximate="tanh") if activation == "gelu"
              else torch.square(F.relu(uph))).to(x.dtype)
    ye = _expert_mm(he, experts["down"]).float()             # [E,G*C,D]
    ye = ye.reshape(E_l, G, capacity, D)
    yg = torch.einsum("egcd,gnec->gnd", ye, combine).to(x.dtype)
    return yg.reshape(B, T, D), f, p


def _moe_shards(params, x, *, n: int, capacity: int, num_experts: int,
                top_k: int, activation: str):
    """:func:`moe_apply`'s routed experts on a mesh (expert parallelism,
    GShard's layout): each rank routes its batch shard's tokens to all
    E experts, runs the experts of its ``model`` shard on them, and
    sums its experts' outputs; the ranks of a ``model`` group hold
    partial sums of y (``Partial``), and the balance means are a partial
    sum too, of each rank's means over the number of ranks.  Groups must
    not straddle a batch shard (a cell's group of 1024 tokens lies in one
    row); when they would, the tokens are gathered and every rank routes
    them all."""
    mesh = x.device_mesh
    B, T, D = x.shape
    xs = sh.split_spec(x, {0: "batch"})
    sizes = sh.axis_sizes(mesh)
    rows = B // sh.size_of(sizes, xs[0])
    if (rows * T) % n:
        xs = sh.P(*(None,) * 3)
    ex = params["experts"]
    names = [k for k in ("down", "gate", "up") if k in ex]
    es = {k: sh.split_spec(ex[k], {0: "model"}) for k in names}
    ep = es["down"][0] is not None

    dp = [a for a in (xs[0] or ())]
    # the axes the outputs split over: the DP rows, and the experts
    split = dp + (["model"] if ep else [])
    n_split = sh.size_of(sizes, tuple(split))

    def local(xl, router, *ws):
        e0 = 0
        if ep:
            e0 = mesh.get_local_rank("model") * ws[0].shape[0]
        y, f, p = _moe_routed(xl, router, dict(zip(names, ws)), n=n,
                              capacity=capacity, top_k=top_k,
                              activation=activation, expert0=e0)
        # each rank's share of the means, a partial sum over the ranks the
        # outputs split over: so that a rank's gradient through them is its
        # share, as through its rows' and experts' y
        return y, f / n_split, p / n_split

    y_pl = tuple(
        sh.Partial() if name == "model" and ep else
        sh.Shard(0) if name in dp else sh.Replicate()
        for name in mesh.mesh_dim_names)
    mean_pl = tuple(sh.Partial() if name in split else sh.Replicate()
                    for name in mesh.mesh_dim_names)
    y, f, p = sh.on_shards(
        local, (x, params["router"], *(ex[k] for k in names)),
        (xs, sh.P(None, None), *(es[k] for k in names)),
        (y_pl, mean_pl, mean_pl))
    return y, num_experts * torch.sum(f * p)


def moe_apply_dense(params, x, *, num_experts: int, top_k: int,
                    activation: str = "swiglu"):
    """Dropless decode-path MoE: every expert runs on every token, the
    top-k weights combine.  Exact (no capacity drops); at decode batch
    sizes every expert is active anyway, so the bytes read are the expert
    weights either way.  x: [B,T,D] -> [B,T,D]."""
    B, T, D = x.shape
    ex = params["experts"]
    names = [k for k in ("down", "gate", "up") if k in ex]
    if isinstance(x, DTensor):
        y = _dense_shards(x, params["router"], [ex[k] for k in names],
                          names, top_k=top_k, activation=activation)
    else:
        y = _dense_experts(x.reshape(B * T, D), params["router"],
                           dict(zip(names, (ex[k] for k in names))),
                           top_k=top_k, activation=activation
                           ).reshape(B, T, D)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, activation=activation)
    return y


def _dense_experts(xt, router, experts, *, top_k: int, activation: str,
                   expert0: int = 0):
    """Every expert (or the slice of them from ``expert0`` that
    ``experts`` holds) on every token of xt [N, D], combined with the
    top-k weights -> [N, D]."""
    N, D = xt.shape
    logits = proj(xt.float(), router)
    weights, _ = _top_k_mask(logits, top_k)                  # [N,E]
    E = experts["down"].shape[0]
    weights = weights[:, expert0:expert0 + E]
    xe = xt.expand(E, N, D)
    # Each expert's mlp_apply, batched over the expert axis.
    if activation in ("swiglu", "geglu"):
        g = _expert_mm_f32(xe, experts["gate"])
        u = _expert_mm_f32(xe, experts["up"])
        act = F.silu(g) if activation == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = (act * u).to(xt.dtype)
    elif activation == "gelu":
        h = F.gelu(_expert_mm_f32(xe, experts["up"]),
                   approximate="tanh").to(xt.dtype)
    else:
        raise ValueError(activation)
    ye = _expert_mm_f32(h, experts["down"]).to(xt.dtype)     # [E,N,D]
    return torch.einsum("end,ne->nd", ye.float(), weights).to(xt.dtype)


def _dense_shards(x, router, ws, names, *, top_k: int, activation: str):
    """:func:`moe_apply_dense`'s experts on a mesh: each rank's batch
    shard through its ``model`` shard of the experts, partial sums over
    ``model`` (expert parallelism)."""
    mesh = x.device_mesh
    B, T, D = x.shape
    rows = sh.split_spec(x, {0: "batch"})[0]
    es = sh.split_spec(ws[0], {0: "model"})
    ep = es[0] is not None

    def local(xl, router, *ws):
        e0 = mesh.get_local_rank("model") * ws[0].shape[0] if ep else 0
        b = xl.shape[0]
        return _dense_experts(
            xl.reshape(b * T, D), router, dict(zip(names, ws)),
            top_k=top_k, activation=activation, expert0=e0
        ).reshape(b, T, D)

    out = tuple(sh.Partial() if name == "model" and ep else
                sh.Shard(0) if rows and name in rows else sh.Replicate()
                for name in mesh.mesh_dim_names)
    return sh.on_shards(local, (x, router, *ws),
                        (sh.P(rows, None, None), sh.P(None, None),
                         *(sh.split_spec(w, {0: "model"}) for w in ws)), out)
