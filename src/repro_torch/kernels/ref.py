"""Plain PyTorch oracles for the kernels (the ``ref.py`` contract of
:mod:`repro.kernels.ref`).

They are the plain versions the kernel wrappers take on the CPU and
the yardstick the CUDA kernels are held to on the card.  Deliberately
naive — full score matrices, no blocking, the scan one token at a time,
f32 throughout — so their correctness is auditable at a glance.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: [B,H,T,D]; k/v: [B,KV,S,D]; H = KV*G.  Returns [B,H,T,D]."""
    B, H, T, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, T, D).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        s = torch.where(mask[None, None, None], s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bksd->bkgtd", w, v.float())
    return o.reshape(B, H, T, D).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: [B,H,D]; caches: [B,KV,S,D]; lengths: i32[B] valid lengths."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None], s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def rwkv6_scan_ref(r, k, v, logw, u, *, return_state: bool = False):
    """Sequential RWKV6 WKV recurrence — the exact oracle.

    r/k/v: [B,H,T,K]; logw: [B,H,T,K] (log decay, <0); u: [H,K] bonus.
    Returns y [B,H,T,K] (V == K) in fp32, and with ``return_state``
    also the final state S_T [B,H,K,K] (the JAX oracle returns y alone):

        y_t = r_t · (S_{t-1} + u ⊙ k_t v_tᵀ)
        S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,    S_0 = 0
    """
    B, H, T, K = r.shape
    r, k, v = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uf = u.float()[None, :, :, None]
    S = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, :, t], v[:, :, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], S + uf * kv))
        S = w[:, :, t, :, None] * S + kv
    y = torch.stack(ys, dim=2) if ys else r.new_zeros((B, H, 0, K))
    return (y, S) if return_state else y


def mamba_scan_ref(xdt, dt, bc, cc, a, *, return_state: bool = False):
    """Sequential selective-scan oracle.

    xdt/dt: [B,T,I]; bc/cc: [B,T,N]; a: [I,N] (negative) -> y [B,T,I]
    in fp32, and with ``return_state`` also the final state h_T [B,I,N]
    fp32 (the JAX oracle returns y alone):

        h_t = exp(dt_t·A) h_{t-1} + xdt_t·B_t;   y_t = C_t · h_t,   h_0 = 0
    """
    B, T, I = xdt.shape
    N = bc.shape[-1]
    xdt, dt, bc, cc = xdt.float(), dt.float(), bc.float(), cc.float()
    a = a.float()
    h = torch.zeros((B, I, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t, :, None] * a)            # [B,I,N]
        h = decay * h + xdt[:, t, :, None] * bc[:, t, None, :]
        ys.append(torch.sum(h * cc[:, t, None, :], dim=-1))
    y = torch.stack(ys, dim=1) if ys else xdt.new_zeros((B, 0, I))
    return (y, h) if return_state else y
