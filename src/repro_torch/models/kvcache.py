"""KV caches for decode (PyTorch port of :mod:`repro.models.kvcache`).

Leaves are stacked over the layer axis, as in the JAX package, so the
cache keeps its layout and the serving engine's slot splice ports
directly:

* GQA:   k/v  [L, B, S, KV, D]

``lengths: i32[B]`` (kept beside the stages by ``LM.init_cache``) counts
valid tokens per sequence, shared across layers.  The MLA and SSM
caches come with those mixers.
"""

from __future__ import annotations

import torch


def gqa_cache_init(num_layers, batch, max_len, num_kv_heads, head_dim,
                   dtype=torch.bfloat16, device=None):
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
