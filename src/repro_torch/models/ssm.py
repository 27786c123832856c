"""State-space blocks: Mamba (Jamba) and RWKV6 ("Finch") (PyTorch port
of :mod:`repro.models.ssm`).

Parameters are nested dict-likes in the JAX package's layout.  Mamba:
``in_proj``, ``conv_w``/``conv_b``, ``x_proj``, ``dt_proj``,
``out_proj`` in bf16, ``dt_bias``, ``A_log`` and ``D`` in f32 (JAX's
empty ``meta`` dict is not carried).  RWKV6: ``mix/{r,k,v,w,g}``,
``ln_x/{scale,bias}``; weights bf16, the mix coefficients, decay, bonus
and ``ln_x`` f32.  Each sequence mixer runs the whole sequence one of
two ways, chosen by ``impl`` as the attention mixers are:

* ``"blockwise"`` / ``"reference"`` — the chunked plain form of the JAX
  package.  RWKV6 (``ssm.py:292-322``): exact pair decays inside a
  chunk, the ``[K, V]`` state carried across chunks by a Python loop.
  Mamba (``ssm.py:94-157``): the chunk's decays and inputs materialised
  as JAX's are, and JAX's in-chunk ``associative_scan`` replaced by the
  sequential recurrence over the chunk's tokens (the same ``h_t = a_t
  h_{t-1} + u_t``, summed in order rather than as a tree).
* ``"pallas"`` — the hand-written Hopper kernels
  (:func:`repro_torch.kernels.ops.rwkv6_scan`,
  :func:`repro_torch.kernels.ops.mamba_scan`), which walk the tokens
  themselves and return the final state; on CPU tensors their plain
  versions run.  The JAX model never reaches its Pallas scans
  (``ssm.py:133-146`` runs ``lax.associative_scan``, ``ssm.py:322``
  ``lax.scan``); the port's prefill does.

Decode (one token) is the exact recurrence in plain PyTorch, as it is
plain ``jnp`` in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import shards as sh
from repro_torch.models.layers import DEFAULT_DTYPE, dense_init, proj

DECAY_LORA = 64               # rank of the decay LoRA (JAX's default)
_MIX_STREAMS = ("r", "k", "v", "w", "g")
_GROUP_NORM_EPS = 64e-5


# ===========================================================================
# Mamba (v1 selective SSM, as interleaved in Jamba)
# ===========================================================================

def _dt_rank(d_model: int, dt_rank: int | None) -> int:
    return dt_rank or max(1, math.ceil(d_model / 16))


def mamba_weight_shapes(*, d_model: int, d_state: int = 16,
                        d_conv: int = 4, expand: int = 2,
                        dt_rank: int | None = None) -> dict:
    """Name -> (shape, dtype) of a mamba mixer's weights."""
    f32, I = torch.float32, expand * d_model
    R = _dt_rank(d_model, dt_rank)
    return {
        "in_proj": ((d_model, 2 * I), DEFAULT_DTYPE),
        "conv_w": ((d_conv, I), DEFAULT_DTYPE),
        "conv_b": ((I,), DEFAULT_DTYPE),
        "x_proj": ((I, R + 2 * d_state), DEFAULT_DTYPE),
        "dt_proj": ((R, I), DEFAULT_DTYPE),
        "dt_bias": ((I,), f32),
        "A_log": ((I, d_state), f32),
        "D": ((I,), f32),
        "out_proj": ((I, d_model), DEFAULT_DTYPE),
    }


@torch.no_grad()
def mamba_init(gen: torch.Generator, p, *, d_model: int, d_state: int = 16,
               d_conv: int = 4, expand: int = 2,
               dt_rank: int | None = None):
    """Fill ``p`` (a dict-like of :func:`mamba_weight_shapes`) in place
    with the JAX ``mamba_init`` values drawn from ``gen``: fan-in
    truncated-normal projections, ``conv_w ~ N(0, 1/d_conv)``, ``conv_b``
    0, ``dt_bias = log(expm1(dt))`` for ``dt ~ U(0.001, 0.1)``, the
    S4D-real ``A_log = log(1..N)`` on every channel, ``D`` 1."""
    I = expand * d_model
    R = _dt_rank(d_model, dt_rank)
    dev = p["A_log"].device
    dense_init(gen, d_model, 2 * I, out=p["in_proj"])
    conv = torch.empty((d_conv, I), dtype=torch.float32, device=dev)
    p["conv_w"].copy_(conv.normal_(generator=gen).mul_(
        1.0 / math.sqrt(d_conv)))
    p["conv_b"].zero_()
    dense_init(gen, I, R + 2 * d_state, out=p["x_proj"])
    dense_init(gen, R, I, out=p["dt_proj"])
    dt = torch.empty((I,), dtype=torch.float32, device=dev)
    dt = torch.clamp(dt.uniform_(generator=gen) * 0.099 + 0.001, min=1e-4)
    p["dt_bias"].copy_(torch.log(torch.expm1(dt)))
    p["A_log"].copy_(torch.log(torch.arange(
        1, d_state + 1, dtype=torch.float32, device=dev)).expand(I, d_state))
    p["D"].fill_(1.0)
    dense_init(gen, I, d_model, out=p["out_proj"])


def _mamba_project(params, x):
    """x: [B,L,D] -> (xs, z), each [B,L,d_inner] in x's dtype (views of
    one f32-accumulated projection, rounded once)."""
    xz = proj(x, params["in_proj"], out_dtype=x.dtype)
    return xz.chunk(2, dim=-1)


def _mamba_ssm_inputs(params, xs, *, d_state: int, dt_rank: int):
    """-> (dt [B,L,I] f32, Bc [B,L,N] f32, Cc [B,L,N] f32).  Bc and Cc are
    column slices of the ``x_proj`` output (no copy)."""
    xp = proj(xs, params["x_proj"])                        # f32
    dt_in = xp[..., :dt_rank]
    Bc = xp[..., dt_rank:dt_rank + d_state]
    Cc = xp[..., dt_rank + d_state:]
    dt = dt_in @ params["dt_proj"].float()
    dt = dt + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros((), device=dt.device))  # softplus
    return dt, Bc, Cc


def _conv1d_causal(params, xs, conv_state=None):
    """Depthwise causal conv over time, then silu.  xs: [B,L,C];
    conv_state: [B,d_conv-1,C], the tail of the previous segment (decode)
    or None (zeros)."""
    w = params["conv_w"].float()                           # [K,C]
    K = w.shape[0]
    if conv_state is None:
        pad = sh.pad(xs, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
    L = xs.shape[1]
    acc = torch.zeros(xs.shape, dtype=torch.float32, device=xs.device)
    for i in range(K):
        acc = acc + pad[:, i:i + L].float() * w[i]
    acc = acc + params["conv_b"].float()
    return F.silu(acc).to(xs.dtype)


def _conv_tail(xs, d_conv: int, conv0=None):
    """The last ``d_conv - 1`` conv inputs [B,d_conv-1,C], taken before
    the convolution, as JAX takes them.  A segment shorter than that is
    preceded by ``conv0`` (zeros at the start): JAX would return a short
    tail there, which its cache cannot hold."""
    n = d_conv - 1
    if xs.shape[1] < n:
        prev = (torch.zeros((xs.shape[0], n, xs.shape[2]), dtype=xs.dtype,
                            device=xs.device)
                if conv0 is None else conv0.to(xs.dtype))
        xs = torch.cat([prev, xs], dim=1)
    return xs[:, xs.shape[1] - n:]


def _mamba_chunked_scan(xs, dt, Bc, Cc, A, Dskip, *, chunk: int, h0=None):
    """The JAX chunked form, an associative scan inside each chunk (JAX's
    ``lax.associative_scan`` order) and the state carried across chunks:
    xs [B,T,I], dt [B,T,I] f32, Bc/Cc [B,T,N] f32, A [I,N] -> (y [B,T,I]
    f32 including the ``D`` skip, h_T [B,I,N] f32).  Padded tokens carry
    dt = 0: decay 1, input 0, the state untouched."""
    B, T, I = xs.shape
    N = A.shape[-1]
    chunk = min(chunk, T)
    nch = -(-T // chunk)
    Tp = nch * chunk
    xs = xs.float()
    if Tp != T:
        xs, dt, Bc, Cc = (F.pad(t, (0, 0, 0, Tp - T))
                          for t in (xs, dt, Bc, Cc))
    h = (torch.zeros((B, I, N), dtype=torch.float32, device=xs.device)
         if h0 is None else h0.float())
    ys = []
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, bc, cc = xs[:, sl], dt[:, sl], Bc[:, sl], Cc[:, sl]
        a = torch.exp(dtc[..., None] * A)                  # [B,L,I,N]
        u = (dtc * xc)[..., None] * bc[:, :, None, :]
        a_sc, u_sc = _associative_scan(a, u)
        h_t = a_sc * h[:, None] + u_sc                     # [B,L,I,N]
        h = h_t[:, -1]
        ys.append(torch.einsum("blin,bln->bli", h_t, cc) + Dskip * xc)
    return torch.cat(ys, dim=1)[:, :T], h


def _combine(p, q):
    """The recurrence's combine: ``(a1, u1) . (a2, u2) = (a1·a2,
    a2·u1 + u2)``, h = a h_prev + u composed."""
    return p[0] * q[0], q[0] * p[1] + q[1]


def _associative_scan(a, u):
    """The inclusive scan of ``_combine`` along dim 1, in
    ``lax.associative_scan``'s odd-even order: the pairs combined, their
    scan taken recursively, and the even positions filled in from it
    (log2 L levels, O(L) work)."""
    L = a.shape[1]
    if L < 2:
        return a, u
    odd = _associative_scan(*_combine((a[:, 0:-1:2], u[:, 0:-1:2]),
                                      (a[:, 1::2], u[:, 1::2])))
    if L % 2:
        even = _combine(odd, (a[:, 2::2], u[:, 2::2]))
    else:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], u[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([u[:, :1], even[1]], dim=1))

    def interleave(e, o):
        n = o.shape[1]
        both = torch.stack([e[:, :n], o], dim=2).flatten(1, 2)
        return torch.cat([both, e[:, n:]], dim=1) if e.shape[1] > n else both

    return interleave(even[0], odd[0]), interleave(even[1], odd[1])


def _mamba_scan_shards(scan, xs, dt, Bc, Cc, A, Dskip):
    """``scan(xs, dt, Bc, Cc, A, D) -> (y, h)`` on each rank's shards
    when the inputs are ``DTensor``s: batch over the DP axes, the inner
    channels over ``model`` (the scan is one recurrence a channel)."""
    if not isinstance(xs, sh.DTensor):
        return scan(xs, dt, Bc, Cc, A, Dskip)
    ch = sh.split_spec(A, {0: "model"})[0]
    bi = sh.split_spec(xs, {0: "batch"})[0]
    x_spec = sh.P(bi, None, ch)
    n_spec = sh.P(bi, None, None)
    return sh.on_shards(scan, (xs, dt, Bc, Cc, A, Dskip),
                        (x_spec, x_spec, n_spec, n_spec, sh.P(ch, None),
                         sh.P(ch)),
                        (x_spec, sh.P(bi, ch, None)))


def mamba_apply(params, x, *, d_state: int = 16, d_conv: int = 4,
                dt_rank: int | None = None, chunk: int = 256, h0=None,
                conv0=None, return_state: bool = False,
                impl: str = "blockwise"):
    """Full-sequence selective scan.  x: [B,T,D] -> y [B,T,D]; with
    ``return_state`` also the final (h [B,d_inner,N] f32, conv tail
    [B,d_conv-1,d_inner]).

    ``impl="pallas"`` runs the ``mamba_scan`` kernel on ``xdt = dt·xs``
    and adds the ``D`` skip, the ``silu(z)`` gate and ``out_proj`` outside
    it, as the Pallas kernel's docstring says; the kernel starts from a
    zero state, so ``h0`` must be None there (the LM never passes it)."""
    B, T, D = x.shape
    dt_rank = _dt_rank(D, dt_rank)
    xs, z = _mamba_project(params, x)
    conv_tail = _conv_tail(xs, d_conv, conv0) if return_state else None
    xs = _conv1d_causal(params, xs, conv0)
    dt, Bc, Cc = _mamba_ssm_inputs(params, xs, d_state=d_state,
                                   dt_rank=dt_rank)
    A = -torch.exp(params["A_log"])                        # [I,N] < 0
    if impl == "pallas":
        if h0 is not None:
            raise ValueError("the mamba_scan kernel starts from a zero "
                             "state; h0 is not supported with "
                             "impl='pallas'")

        def scan(xs, dt, Bc, Cc, A, Dskip):
            xsf = xs.float()
            y, h_fin = ops.mamba_scan(dt * xsf, dt, Bc, Cc, A, chunk=chunk,
                                      return_state=True)
            return y + Dskip * xsf, h_fin
    elif impl in ("blockwise", "reference"):
        def scan(xs, dt, Bc, Cc, A, Dskip):
            return _mamba_chunked_scan(xs, dt, Bc, Cc, A, Dskip,
                                       chunk=chunk, h0=h0)
    else:
        raise ValueError(f"unknown mamba impl {impl!r}")
    y, h_fin = _mamba_scan_shards(scan, xs, dt, Bc, Cc, A, params["D"])
    y = (y * F.silu(z.float())).to(x.dtype)
    out = proj(y, params["out_proj"], out_dtype=x.dtype)
    if return_state:
        return out, (h_fin, conv_tail)
    return out


def mamba_state_init(batch: int, *, d_model: int, d_state: int = 16,
                     d_conv: int = 4, expand: int = 2,
                     dtype=DEFAULT_DTYPE, device=None) -> dict:
    I = expand * d_model
    return {
        "h": torch.zeros((batch, I, d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, d_conv - 1, I), dtype=dtype,
                            device=device),
    }


def mamba_decode_step(params, x, state, *, d_state: int = 16,
                      d_conv: int = 4, dt_rank: int | None = None):
    """One-token recurrence.  x: [B,1,D]; state: {'h', 'conv'} ->
    (out [B,1,D], {'h', 'conv'}), new tensors."""
    B, _, D = x.shape
    dt_rank = _dt_rank(D, dt_rank)
    xs, z = _mamba_project(params, x)
    conv = state["conv"]
    new_conv = torch.cat([conv[:, 1:], xs.to(conv.dtype)], dim=1) \
        if d_conv > 1 else conv
    xs = _conv1d_causal(params, xs, conv)
    dt, Bc, Cc = _mamba_ssm_inputs(params, xs, d_state=d_state,
                                   dt_rank=dt_rank)
    A = -torch.exp(params["A_log"])
    x0 = xs[:, 0].float()
    dA = torch.exp(dt[:, 0, :, None] * A)                  # [B,I,N]
    u = (dt[:, 0] * x0)[..., None] * Bc[:, 0, None, :]
    h = dA * state["h"] + u
    y = torch.einsum("bin,bn->bi", h, Cc[:, 0])
    y = y + params["D"] * x0
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = proj(y, params["out_proj"], out_dtype=x.dtype)
    return out[:, None], {"h": h, "conv": new_conv}


# ===========================================================================
# RWKV6 ("Finch": data-dependent decay)
# ===========================================================================

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


def _rwkv_scan_shards(scan, r, k, v, logw, u, *state):
    """``scan(r, k, v, logw, u[, S]) -> (y, S)`` on each rank's shards
    when the streams are ``DTensor``s: batch over the DP axes, whole heads
    over ``model`` (the recurrence is one a head)."""
    if not isinstance(r, sh.DTensor):
        return scan(r, k, v, logw, u, *state)
    hd = sh.split_spec(u, {0: "model"})[0]
    bi = sh.split_spec(r, {0: "batch"})[0]
    x_spec = sh.P(bi, None, hd)
    s_spec = sh.P(bi, hd, None, None)
    return sh.on_shards(scan, (r, k, v, logw, u, *state),
                        (x_spec,) * 4 + (sh.P(hd, None),)
                        + (s_spec,) * len(state), (x_spec, s_spec))


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

        def scan(r, k, v, logw, u):
            B, T, D = r.shape
            H = D // head_dim

            def heads(t):   # [B,T,D] -> [B,H,T,K], a view
                return t.view(B, T, H, head_dim).transpose(1, 2)

            y, s_fin = ops.rwkv6_scan(heads(r), heads(k), heads(v),
                                      heads(logw), u, chunk=chunk,
                                      return_state=True)
            return y.transpose(1, 2).reshape(B, T, D), s_fin
    elif impl in ("blockwise", "reference"):
        def scan(r, k, v, logw, u):
            return _chunked_scan(r, k, v, logw, u, head_dim=head_dim,
                                 chunk=chunk, s0=s0)
    else:
        raise ValueError(f"unknown rwkv6 impl {impl!r}")
    y, s_fin = _rwkv_scan_shards(scan, r, k, v, logw, u)
    out = _group_norm_gate_out(params, y, g, x, head_dim=head_dim)
    if return_state:
        return out, (x[:, -1:, :], s_fin)
    return out


def rwkv6_attn_decode(params, x, x_prev, S, *, head_dim: int = 64):
    """Exact single-token recurrence.  x: [B,1,D]; S: [B,H,K,V] f32 ->
    (out [B,1,D], (x, S_new))."""
    D = x.shape[-1]
    K = head_dim
    r, k, v, g, logw = _rwkv_streams(params, x, x_prev)
    u = params["bonus_u"].reshape(D // K, K)

    def step(r, k, v, logw, u, S):
        B, _, D = r.shape
        H = D // K
        rh, kh, vh = (t.reshape(B, H, K) for t in (r, k, v))
        w = torch.exp(logw.reshape(B, H, K))
        kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
        y = torch.einsum("bhk,bhkv->bhv", rh, S + u[None, :, :, None] * kv)
        return y.reshape(B, 1, D), w[..., None] * S + kv

    y, S_new = _rwkv_scan_shards(step, r, k, v, logw, u, S)
    out = _group_norm_gate_out(params, y, g, x, head_dim=head_dim)
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
