#!/usr/bin/env python3
"""How far apart two correct runs of rwkv6-1.6b's logits can be.

    python3 scripts/torch_rwkv_noise.py [--seed 0]

Builds the serving model of ``repro_torch.launch.serve --arch
rwkv6-1.6b`` at full width on the CUDA card (random weights from
``--seed``) and feeds one seeded 16-token prompt through ``forward``:

1. with the ``rwkv6_scan`` kernel (``attn_impl="pallas"``), with the
   chunked plain scan (``"blockwise"``) and with the kernel's plain
   version (the sequential recurrence) in its place;
2. with the kernel again after a one-ulp change of one bf16 element of
   the embedding output (token 5, channel 7);
3. the first two again on an f32 copy of the same weights.

It prints the cosine similarity of the last token's logits for each
pair, the relative difference of the residual stream layer by layer
(kernel vs blockwise), and the share of one layer's bf16 mixer outputs
that differ between the two scans from the same input.  One JSON object
is the last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.launch import serve
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed_apply, unembed_apply

    model = serve.build_model(serve.parse_args(
        ["--arch", "rwkv6-1.6b", "--seed", str(args.seed)]))
    cfg = model.cfg
    rng = np.random.default_rng(3)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 16)),
                          dtype=torch.int32, device="cuda")

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.float().flatten(), b.float().flatten(), dim=0))

    @torch.no_grad()
    def run(m, impl, x0=None, sequential=False):
        """Last-token logits and the residual stream after each layer."""
        kernel = rs.rwkv6_scan_cuda
        if sequential:
            rs.rwkv6_scan_cuda = rs.rwkv6_scan_plain
        try:
            x = embed_apply(m.embed, prompt) if x0 is None else x0
            xs = [x]
            for lp in m.layers:
                h = m.norm_apply(lp.mixer_norm, x, eps=cfg.norm_eps)
                x = x + ssm.rwkv6_attn(lp.mixer, h, head_dim=cfg.rwkv_head_dim,
                                       chunk=cfg.rwkv_chunk, impl=impl)
                h = m.norm_apply(lp.ffn_norm, x, eps=cfg.norm_eps)
                x = x + ssm.rwkv6_channel_mix(lp.ffn, h)
                xs.append(x)
            x = m.norm_apply(m.final_norm, x, eps=cfg.norm_eps)
            return unembed_apply(m._head(), x)[0, -1], xs
        finally:
            rs.rwkv6_scan_cuda = kernel

    lk, xk = run(model, "pallas")
    lb, xb = run(model, "blockwise")
    ls, _ = run(model, "pallas", sequential=True)
    x0 = embed_apply(model.embed, prompt).clone()
    x0.view(torch.int16)[0, 5, 7] += 1           # the next bf16 magnitude
    lp_, _ = run(model, "pallas", x0=x0)
    layer_rel = [float((a.float() - b.float()).norm() / a.float().norm())
                 for a, b in zip(xk, xb)]
    flips = {}
    for li in (0, cfg.num_layers // 2, cfg.num_layers - 1):
        lp = model.layers[li]
        h = model.norm_apply(lp.mixer_norm, xk[li], eps=cfg.norm_eps)
        a, b = (ssm.rwkv6_attn(lp.mixer, h, head_dim=cfg.rwkv_head_dim,
                               chunk=cfg.rwkv_chunk, impl=impl)
                for impl in ("pallas", "blockwise"))
        flips[li] = float((a != b).float().mean())
    model32 = copy.deepcopy(model).float()
    lk32, _ = run(model32, "pallas")
    lb32, _ = run(model32, "blockwise")
    summary = {
        "device": torch.cuda.get_device_name(0), "arch": cfg.name,
        "seed": args.seed,
        "bf16_cos_kernel_blockwise": cos(lk, lb),
        "bf16_cos_kernel_sequential_plain": cos(lk, ls),
        "bf16_cos_blockwise_sequential_plain": cos(lb, ls),
        "bf16_cos_one_ulp_embedding_change": cos(lk, lp_),
        "f32_cos_kernel_blockwise": cos(lk32, lb32),
        "f32_max_abs_diff_kernel_blockwise": float(
            (lk32 - lb32).abs().max()),
        "bf16_residual_rel_diff_by_layer": layer_rel,
        "bf16_mixer_share_differing": flips,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
