"""RWKV6 ("Finch") blocks (PyTorch port of the RWKV6 half of
:mod:`repro.models.ssm`; Mamba is not ported yet).

Parameters are nested dict-likes in the JAX package's layout
(``mix/{r,k,v,w,g}``, ``ln_x/{scale,bias}``); weights are bf16, the mix
coefficients, decay, bonus and ``ln_x`` f32.  The time-mix runs the
whole sequence one of two ways, chosen by ``impl`` as the attention
mixers are:

* ``"blockwise"`` / ``"reference"`` — the chunked plain form of the JAX
  package (``ssm.py:292-322``): exact pair decays inside a chunk, the
  ``[K, V]`` state carried across chunks by a Python loop.
* ``"pallas"`` — the hand-written Hopper kernel
  (:func:`repro_torch.kernels.ops.rwkv6_scan`), which walks the tokens
  itself and returns the final state; on CPU tensors its plain version
  runs.  The JAX model never reaches its Pallas scan (``ssm.py:322``
  runs ``lax.scan``); the port's prefill does.

Decode (one token) is the exact recurrence in plain PyTorch, as it is
plain ``jnp`` in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import DEFAULT_DTYPE, dense_init, proj

DECAY_LORA = 64               # rank of the decay LoRA (JAX's default)
_MIX_STREAMS = ("r", "k", "v", "w", "g")
_GROUP_NORM_EPS = 64e-5


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def rwkv6_weight_shapes(d_model: int) -> dict:
    """Nested name -> (shape, dtype) of the time-mix weights."""
    f32, D = torch.float32, d_model
    return {
        "mix": {s: ((D,), f32) for s in _MIX_STREAMS},
        "wr": ((D, D), DEFAULT_DTYPE), "wk": ((D, D), DEFAULT_DTYPE),
        "wv": ((D, D), DEFAULT_DTYPE), "wg": ((D, D), DEFAULT_DTYPE),
        "wo": ((D, D), DEFAULT_DTYPE),
        "decay_base": ((D,), f32),
        "decay_A": ((D, DECAY_LORA), DEFAULT_DTYPE),
        "decay_B": ((DECAY_LORA, D), DEFAULT_DTYPE),
        "bonus_u": ((D,), f32),
        "ln_x": {"scale": ((D,), f32), "bias": ((D,), f32)},
    }


def rwkv6_channel_mix_weight_shapes(d_model: int, d_ff: int) -> dict:
    """Name -> (shape, dtype) of the channel-mix weights."""
    f32 = torch.float32
    return {
        "mix_k": ((d_model,), f32), "mix_r": ((d_model,), f32),
        "wk": ((d_model, d_ff), DEFAULT_DTYPE),
        "wv": ((d_ff, d_model), DEFAULT_DTYPE),
        "wr": ((d_model, d_model), DEFAULT_DTYPE),
    }


@torch.no_grad()
def rwkv6_init(gen: torch.Generator, p, *, d_model: int):
    """Fill ``p`` (a nested dict-like of tensors of
    :func:`rwkv6_weight_shapes`) in place with the JAX ``rwkv6_init``
    values drawn from ``gen``: mix coefficients 0.5, fan-in
    truncated-normal projections, ``decay_base = linspace(-6, -0.5)``, a
    rank-``DECAY_LORA`` decay LoRA, ``bonus_u ~ N(0, 0.1²)``, ``ln_x``
    ones and zeros."""
    D = d_model
    for s in _MIX_STREAMS:
        p["mix"][s].fill_(0.5)
    for name in ("wr", "wk", "wv", "wg", "wo"):
        dense_init(gen, D, D, out=p[name])
    p["decay_base"].copy_(torch.linspace(-6.0, -0.5, D))
    dense_init(gen, D, DECAY_LORA, out=p["decay_A"])
    dense_init(gen, DECAY_LORA, D, out=p["decay_B"])
    p["bonus_u"].normal_(generator=gen).mul_(0.1)
    p["ln_x"]["scale"].fill_(1.0)
    p["ln_x"]["bias"].fill_(0.0)


@torch.no_grad()
def rwkv6_channel_mix_init(gen: torch.Generator, p, *, d_model: int,
                           d_ff: int):
    """Fill ``p`` in place with mix coefficients 0.5 and fan-in
    truncated-normal weights, as the JAX ``rwkv6_channel_mix_init``."""
    shapes = rwkv6_channel_mix_weight_shapes(d_model, d_ff)
    p["mix_k"].fill_(0.5)
    p["mix_r"].fill_(0.5)
    for name in ("wk", "wv", "wr"):
        fan_in, fan_out = shapes[name][0]
        dense_init(gen, fan_in, fan_out, out=p[name])


# ---------------------------------------------------------------------------
# Time-mix
# ---------------------------------------------------------------------------

def _token_shift(x, x_prev, mu):
    """lerp(x_t, x_{t-1}, mu): RWKV token shift.  x: [B,T,D]; x_prev is
    the last token of the previous segment [B,1,D] (zeros at start)."""
    prev = torch.cat([x_prev, x[:, :-1]], dim=1)
    return x + (prev - x) * mu


def _rwkv_streams(params, x, x_prev):
    """r, k, v, g and the log decay, all f32 [B,T,D].  The token-shift
    mixes run in x's dtype (the coefficients cast to it, as in JAX); the
    projections accumulate in f32."""
    mix = params["mix"]
    xr, xk, xv, xw, xg = (_token_shift(x, x_prev, mix[s].to(x.dtype))
                          for s in _MIX_STREAMS)
    r = proj(xr, params["wr"])
    k = proj(xk, params["wk"])
    v = proj(xv, params["wv"])
    g = proj(xg, params["wg"])
    # data-dependent decay (Finch): w = exp(-exp(base + tanh(x A) B))
    dd = torch.tanh(proj(xw, params["decay_A"])) @ params["decay_B"].float()
    logw = -torch.exp(torch.clamp(params["decay_base"] + dd, -20.0, 4.0))
    return r, k, v, g, logw


def _chunked_scan(r, k, v, logw, u, *, head_dim: int, chunk: int, s0=None):
    """The JAX chunked form: r/k/v/logw f32 [B,T,D], u [H,K] -> (y f32
    [B,T,D], S_T [B,H,K,V]).  Inside a chunk the pair decays are exact
    (exponent <= 0 for t > s); across chunks the state is carried."""
    B, T, D = r.shape
    H, K = D // head_dim, head_dim
    chunk = min(chunk, T)
    nch = -(-T // chunk)
    Tp = nch * chunk
    if Tp != T:   # zero r/k/v, log w = 0 (w = 1): the state is untouched
        r, k, v, logw = (F.pad(t, (0, 0, 0, Tp - T)) for t in (r, k, v, logw))

    def heads(t):   # [B,Tp,D] -> [nch,B,H,chunk,K]
        return t.reshape(B, nch, chunk, H, K).permute(1, 0, 3, 2, 4)

    r_c, k_c, v_c, lw_c = map(heads, (r, k, v, logw))
    u = u.reshape(H, 1, K)
    S = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
         if s0 is None else s0)
    tri = (torch.arange(chunk, device=r.device)[:, None]
           > torch.arange(chunk, device=r.device)[None, :])[..., None]
    ys = []
    for rc, kc, vc, lwc in zip(r_c, k_c, v_c, lw_c):   # [B,H,L,K]
        acum = torch.cumsum(lwc, dim=2)      # inclusive cumsum of log w
        a_before = acum - lwc
        expo = a_before[:, :, :, None, :] - acum[:, :, None, :, :]
        pair = torch.where(tri, torch.exp(torch.where(tri, expo, 0.0)), 0.0)
        scores = torch.einsum("bhlk,bhmk,bhlmk->bhlm", rc, kc, pair)
        y_intra = torch.einsum("bhlm,bhmv->bhlv", scores, vc)
        y_diag = torch.einsum("bhl,bhlv->bhlv",
                              torch.einsum("bhlk,bhlk->bhl", rc * u, kc), vc)
        y_inter = torch.einsum("bhlk,bhkv->bhlv", rc * torch.exp(a_before), S)
        ys.append(y_intra + y_diag + y_inter)
        wtot = torch.exp(acum[:, :, -1])     # [B,H,K]
        k_state = kc * torch.exp(acum[:, :, -1:, :] - acum)
        S = wtot[..., None] * S + torch.einsum("bhlk,bhlv->bhkv",
                                               k_state, vc)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, Tp, D)[:, :T]
    return y, S


def _group_norm_gate_out(params, y, g, x, *, head_dim: int):
    """Per-head group norm (``ln_x``), the silu gate and ``wo``."""
    B, T, D = y.shape
    y = y.reshape(B, T, D // head_dim, head_dim)
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + _GROUP_NORM_EPS)
    y = y.reshape(B, T, D) * params["ln_x"]["scale"] + params["ln_x"]["bias"]
    y = y * F.silu(g)
    return proj(y.to(x.dtype), params["wo"], out_dtype=x.dtype)


def rwkv6_attn(params, x, *, head_dim: int = 64, chunk: int = 64,
               x_prev=None, s0=None, return_state: bool = False,
               impl: str = "blockwise"):
    """RWKV6 time-mix over a full sequence.  x: [B,T,D] -> [B,T,D], and
    with ``return_state`` also ``(x[:, -1:], S_T)``.

    ``impl="pallas"`` runs the kernel, which starts from a zero state:
    ``s0`` must be None there (the LM never passes it)."""
    B, T, D = x.shape
    H = D // head_dim
    if x_prev is None:
        x_prev = torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
    r, k, v, g, logw = _rwkv_streams(params, x, x_prev)
    u = params["bonus_u"].reshape(H, head_dim)
    if impl == "pallas":
        if s0 is not None:
            raise ValueError("the rwkv6_scan kernel starts from a zero "
                             "state; s0 is not supported with impl='pallas'")

        def heads(t):   # [B,T,D] -> [B,H,T,K], a view
            return t.view(B, T, H, head_dim).transpose(1, 2)

        y, s_fin = ops.rwkv6_scan(heads(r), heads(k), heads(v), heads(logw),
                                  u, chunk=chunk, return_state=True)
        y = y.transpose(1, 2).reshape(B, T, D)
    elif impl in ("blockwise", "reference"):
        y, s_fin = _chunked_scan(r, k, v, logw, u, head_dim=head_dim,
                                 chunk=chunk, s0=s0)
    else:
        raise ValueError(f"unknown rwkv6 impl {impl!r}")
    out = _group_norm_gate_out(params, y, g, x, head_dim=head_dim)
    if return_state:
        return out, (x[:, -1:, :], s_fin)
    return out


def rwkv6_attn_decode(params, x, x_prev, S, *, head_dim: int = 64):
    """Exact single-token recurrence.  x: [B,1,D]; S: [B,H,K,V] f32 ->
    (out [B,1,D], (x, S_new))."""
    B, _, D = x.shape
    H = D // head_dim
    K = head_dim
    r, k, v, g, logw = _rwkv_streams(params, x, x_prev)
    rh, kh, vh = r.reshape(B, H, K), k.reshape(B, H, K), v.reshape(B, H, K)
    w = torch.exp(logw.reshape(B, H, K))
    u = params["bonus_u"].reshape(H, K)
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = torch.einsum("bhk,bhkv->bhv", rh, S + u[None, :, :, None] * kv)
    S_new = w[..., None] * S + kv
    out = _group_norm_gate_out(params, y.reshape(B, 1, D), g, x,
                               head_dim=head_dim)
    return out, (x, S_new)


# ---------------------------------------------------------------------------
# Channel-mix
# ---------------------------------------------------------------------------

def rwkv6_channel_mix(params, x, x_prev=None, *, return_state: bool = False):
    """Squared-relu key, sigmoid receptance.  x: [B,T,D] -> [B,T,D], and
    with ``return_state`` also ``x[:, -1:]``."""
    B, T, D = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
    xk = _token_shift(x, x_prev, params["mix_k"].to(x.dtype))
    xr = _token_shift(x, x_prev, params["mix_r"].to(x.dtype))
    k = torch.square(F.relu(proj(xk, params["wk"]))).to(x.dtype)
    v = proj(k, params["wv"])
    r = proj(xr, params["wr"])
    out = (torch.sigmoid(r) * v).to(x.dtype)
    if return_state:
        return out, x[:, -1:, :]
    return out
