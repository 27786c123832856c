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


def _dispatch(logits, top_k: int, capacity: int):
    """Router logits [G,n,E] f32 -> (dispatch [G,n,E,C] one-hot of each
    kept (token, expert) pair's buffer position, combine [G,n,E,C]: the
    dispatch weighted by the renormalized top-k probabilities, the Switch
    aux loss, the top-k expert indices [G,n,K]).  A token whose position
    in its expert's group buffer reaches ``capacity`` is dropped from
    that expert."""
    E = logits.shape[-1]
    vals, idx = _top_k(logits, top_k)                        # [G,n,K]
    probs = torch.softmax(vals, dim=-1)
    oh = F.one_hot(idx, E).float()                           # [G,n,K,E]
    weights = torch.einsum("gnk,gnke->gne", probs, oh)
    mask = oh.sum(dim=-2)                                    # [G,n,E]

    # Load-balancing aux loss (Switch): E * sum_e f_e * p_e.
    probs_full = torch.softmax(logits, dim=-1)
    f = torch.mean(mask, dim=(0, 1))
    p = torch.mean(probs_full, dim=(0, 1))
    aux = E * torch.sum(f * p)

    # Position of each token within its expert's per-group buffer.
    pos = torch.cumsum(mask, dim=1) * mask - 1.0             # [G,n,E]
    in_cap = (pos < capacity) & (pos >= 0)
    pos_oh = F.one_hot(pos.clamp(0, capacity - 1).long(), capacity).float()
    dispatch = pos_oh * in_cap[..., None]                    # [G,n,E,C]
    return dispatch, dispatch * weights[..., None], aux, idx


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
    G = N // n
    xg = x.reshape(G, n, D)
    capacity = max(1, int(math.ceil(n * K / E * capacity_factor)))

    logits = proj(xg.float(), params["router"])              # f32 [G,n,E]
    dispatch, combine, aux, _ = _dispatch(logits, K, capacity)

    xe = torch.einsum("gnd,gnec->egcd", xg.float(), dispatch).to(x.dtype)
    xe = xe.reshape(E, G * capacity, D)                      # [E,G*C,D]
    ex = params["experts"]
    if activation in ("swiglu", "geglu"):
        gph = _expert_mm(xe, ex["gate"]).float()
        uph = _expert_mm(xe, ex["up"]).float()
        act = F.silu(gph) if activation == "swiglu" else \
            F.gelu(gph, approximate="tanh")
        he = (act * uph).to(x.dtype)
    else:
        uph = _expert_mm(xe, ex["up"]).float()
        he = (F.gelu(uph, approximate="tanh") if activation == "gelu"
              else torch.square(F.relu(uph))).to(x.dtype)
    ye = _expert_mm(he, ex["down"]).float()                  # [E,G*C,D]
    ye = ye.reshape(E, G, capacity, D)
    yg = torch.einsum("egcd,gnec->gnd", ye, combine).to(x.dtype)

    y = yg.reshape(B, T, D)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x.reshape(N, D),
                          activation=activation).reshape(B, T, D)
    return y, aux


def moe_apply_dense(params, x, *, num_experts: int, top_k: int,
                    activation: str = "swiglu"):
    """Dropless decode-path MoE: every expert runs on every token, the
    top-k weights combine.  Exact (no capacity drops); at decode batch
    sizes every expert is active anyway, so the bytes read are the expert
    weights either way.  x: [B,T,D] -> [B,T,D]."""
    B, T, D = x.shape
    E = num_experts
    xt = x.reshape(B * T, D)
    logits = proj(xt.float(), params["router"])
    weights, _ = _top_k_mask(logits, top_k)                  # [N,E]
    ex = params["experts"]
    xe = xt.expand(E, B * T, D)
    # Each expert's mlp_apply, batched over the expert axis.
    if activation in ("swiglu", "geglu"):
        g = _expert_mm_f32(xe, ex["gate"])
        u = _expert_mm_f32(xe, ex["up"])
        act = F.silu(g) if activation == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = (act * u).to(x.dtype)
    elif activation == "gelu":
        h = F.gelu(_expert_mm_f32(xe, ex["up"]),
                   approximate="tanh").to(x.dtype)
    else:
        raise ValueError(activation)
    ye = _expert_mm_f32(h, ex["down"]).to(x.dtype)           # [E,N,D]
    y = torch.einsum("end,ne->nd", ye.float(), weights).to(x.dtype)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, activation=activation)
    return y.reshape(B, T, D)
