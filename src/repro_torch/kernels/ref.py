"""Plain PyTorch oracles for the attention kernels (the ``ref.py``
contract of :mod:`repro.kernels.ref`).

They are the plain versions the kernel wrappers take on the CPU and
the yardstick the CUDA kernels are held to on the card.  Deliberately
naive — full score matrices, no blocking, f32 throughout — so their
correctness is auditable at a glance.  The scan oracles
(``rwkv6_scan_ref``, ``mamba_scan_ref``) come with their kernels.
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
