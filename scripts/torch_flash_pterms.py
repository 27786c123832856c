#!/usr/bin/env python3
"""What splitting P into bf16 terms buys in the bf16 flash kernel.

    python3 scripts/torch_flash_pterms.py [--terms 1 2 3] [--seed 0]

The bf16 ``flash_attention`` kernel (``csrc/attention.cu``) feeds the
softmax weights P to the P V product as ``kPTerms`` bf16 terms (3 unless
the build defines ``FLASH_P_TERMS``).  This script builds the checkout's
source once per term count, with ``-DFLASH_P_TERMS=n`` and
``kernels/_build.py``'s flags, all at once, loads each build into the
wrapper in turn and, for each, on the CUDA card:

1. runs jamba's layer-0 prefill attention of ``chip_smoke.py``'s
   teacher-forced prompt (the jamba truncation at full width, random
   weights from ``--seed``; H 64, KV 8, head_dim 128, T 16) and counts
   the bf16 outputs that differ from the plain version (f32) and from
   the correctly rounded result (float64, rounded once), with the worst
   absolute difference;
2. times the kernel at stablelm-12b's long prefill (B 1, H 32, KV 8,
   head_dim 160, T = S = 2048, causal) per call inside a CUDA graph
   (``chip_smoke._device_ms``).

Prints one line per build and one JSON object as the last line, with
the card's ``nvidia-smi`` name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--terms", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_pterms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.models import LM

    src = _build.CSRC / "attention.cu"
    out_dir = _build.BUILD_DIR / "pterms"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(n):
        so = out_dir / f"libattention_p{n}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                               f"-DFLASH_P_TERMS={n}", "-o", str(so),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(proc.stdout + proc.stderr)
        return n, so

    with concurrent.futures.ThreadPoolExecutor(len(args.terms)) as pool:
        libs = dict(pool.map(build, args.terms))

    # jamba's layer-0 prefill attention inputs in the teacher-forced run.
    model = LM(cs.jamba_truncation(), attn_impl="pallas").init(args.seed)
    captured = []
    kernel = kops.flash_attention

    def capture(q, k, v, *, causal=True, block_q=128):
        if not captured:
            captured.append((q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)))
        return kernel(q, k, v, causal=causal, block_q=block_q)

    kops.flash_attention = capture
    try:
        cs._teacher_rows(model, "blockwise")
    finally:
        kops.flash_attention = kernel
    del model
    torch.cuda.empty_cache()
    if not captured:
        raise SystemExit("the kernel route's prefill made no flash call")
    q, k, v = captured[0]
    G = q.shape[1] // k.shape[1]
    T = q.shape[2]
    s = torch.einsum("bhtd,bhsd->bhts", q.double(),
                     k.double().repeat_interleave(G, 1)) / math.sqrt(
                         q.shape[-1])
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool,
                                 device=q.device).triu(1), float("-inf"))
    exact = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, -1),
                         v.double().repeat_interleave(G, 1)).to(q.dtype)
    plain = fa.flash_attention_plain(q, k, v)

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    lq = cs._randn(gen, (1, 2048, 32, 160), bf16).transpose(1, 2)
    lk = cs._randn(gen, (1, 2048, 8, 160), bf16).transpose(1, 2)
    lv = cs._randn(gen, (1, 2048, 8, 160), bf16).transpose(1, 2)

    result = {"card": cs.card_line(), "outputs": plain.numel(), "terms": {}}
    for n, so in sorted(libs.items()):
        lib = ctypes.CDLL(str(so))
        _build._LIBS["attention"] = lib
        fa._LIB = None
        _build.PLANS.clear()
        if fa._lib() is not lib:
            raise SystemExit("the wrapper did not load the build under test")
        got = fa.flash_attention_cuda(q, k, v)
        device_ms = cs._device_ms(lambda: fa.flash_attention_cuda(lq, lk, lv),
                                  10)
        rec = {
            "differ_from_plain": int((got != plain).sum()),
            "differ_from_correctly_rounded": int((got != exact).sum()),
            "max_abs_err_vs_plain": float((got.float() - plain.float())
                                          .abs().max()),
            "device_ms_T2048": device_ms,
        }
        result["terms"][n] = rec
        print(f"kPTerms {n}: {json.dumps(rec)}", flush=True)
    result["plain_differs_from_correctly_rounded"] = int((plain != exact)
                                                          .sum())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
