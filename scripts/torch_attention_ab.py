#!/usr/bin/env python3
"""Time the attention, queue and scan kernels of two checkouts on one
card, in turns.

    python3 scripts/torch_attention_ab.py --before DIR [--after DIR]
        [--only attention|queue|scans]

``DIR`` is the root of a checkout of the repository (for example an
unpacked ``git archive`` of the parent commit); ``--after`` defaults to
this script's own checkout.  Each round runs one child process per
checkout in the order before, after, after, before, so that both meet
the card in the same states.  A child imports ``repro_torch`` from its
checkout, builds its ``attention.cu`` and times, at the serving paths'
shapes in bf16, ``flash_attention`` (B 1, H 32, KV 8, head_dim 160,
T = S = 32 and 2048, causal) and ``decode_attention`` (B 4, S 256,
lengths 1/31/200/256; H 32, KV 8, head_dim 160 and H 64, KV 8, head_dim
128): ``ms`` per wrapper call back to back and ``device_ms`` per call
inside a CUDA graph (``chip_smoke.py``'s ``_time_ms`` and
``_device_ms``), and one ``scaled_dot_product_attention`` call both
ways.  Then the queue kernels at PHOLD's shapes (``chip_smoke.py``'s
``queue_cases``: ``window_extract`` at k 4 and ``front_merge`` of 4 rows
on the front tier PHOLD at ``chip_smoke.py``'s size leaves after
``PHOLD_AB_BATCHES`` super-steps, run by the child's own package), both
ways, beside the launch floor (``launch_floor_ms``: a one-element
``fill_``).  Then the scans (``--only scans``: ``rwkv6_scan`` at
rwkv6-1.6b's heads, B 1, H 32, K 64, and ``mamba_scan`` at jamba's, B 1,
I 16384, N 16, both in f32 at T 16 and 2048, with ``chip_smoke.py``'s
inputs), both ways.  Prints one JSON line per child and a summary line per
checkout, shape and metric (the median over its children), with the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (kernel, B, H, KV, T or S, D)
SHAPES = [("flash_attention", 1, 32, 8, 32, 160),
          ("flash_attention", 1, 32, 8, 2048, 160),
          ("decode_attention", 4, 32, 8, 256, 160),
          ("decode_attention", 4, 64, 8, 256, 128)]
DECODE_LENGTHS = (1, 31, 200, 256)
SCAN_TS = (16, 2048)
PHOLD_AB_BATCHES = 256


def queue_child(cs, out: dict) -> None:
    """The queue kernels on PHOLD's front tier, with this child's
    package."""
    import torch

    from repro_torch.examples import phold

    prog = phold.build_program(num_lps=cs.PHOLD_LPS, t_stop=cs.PHOLD_T_STOP,
                               max_batch_len=4, capacity=cs.PHOLD_CAPACITY)
    sim = prog.build(backend="device", device="cuda", dispatch_mode="switch")
    res = sim.run(phold.initial_state(cs.PHOLD_LPS, "cuda"),
                  max_batches=PHOLD_AB_BATCHES)
    lookaheads = torch.tensor([1.0], device="cuda")
    for name, _, kernel, _, _, _ in cs.queue_cases(res.raw["final_queue"],
                                                   lookaheads):
        out[f"{name} PHOLD"] = {"ms": cs._time_ms(kernel),
                                "device_ms": cs._device_ms(kernel)}
    out["launch_floor"] = {"device_ms": cs.launch_floor_ms()}


def scans_child(cs, out: dict) -> None:
    """The scans at the serving prefill's T 16 and at T 2048, f32:
    ``rwkv6_scan`` at rwkv6-1.6b's heads (B 1, H 32, K 64, views of the
    model's streams), ``mamba_scan`` at jamba's (B 1, I 16384, N 16, B/C
    as slices of the ``x_proj`` output), with this child's package."""
    import torch

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rwkv6_scan as rs

    gen = torch.Generator(device="cuda").manual_seed(6)
    for T in SCAN_TS:
        reps, calls = (20, 10) if T >= 2048 else (300, 50)
        xs = cs.rwkv_inputs(gen, 1, 32, T, 64, torch.float32)

        def rwkv(xs=xs):
            return rs.rwkv6_scan_cuda(*xs)

        out[f"rwkv6_scan H32 K64 T{T}"] = {
            "ms": cs._time_ms(rwkv, reps),
            "device_ms": cs._device_ms(rwkv, calls)}
        xs = cs.mamba_inputs(gen, 1, T, 16384, 16, torch.float32)

        def mamba(xs=xs):
            return ms.mamba_scan_cuda(*xs)

        out[f"mamba_scan I16384 N16 T{T}"] = {
            "ms": cs._time_ms(mamba, reps),
            "device_ms": cs._device_ms(mamba, calls)}


def child(tree: pathlib.Path, only) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    out = {"tree": str(tree)}
    for kernel, B, H, KV, N, D in SHAPES if only in (None,
                                                      "attention") else ():
        if kernel == "flash_attention":
            q = cs._randn(gen, (B, N, H, D), bf16).transpose(1, 2)
            k = cs._randn(gen, (B, N, KV, D), bf16).transpose(1, 2)
            v = cs._randn(gen, (B, N, KV, D), bf16).transpose(1, 2)

            def run(q=q, k=k, v=v):
                return fa.flash_attention_cuda(q, k, v)

            def lib(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
        else:
            q = cs._randn(gen, (B, H, D), bf16)
            k = cs._randn(gen, (B, N, KV, D), bf16).transpose(1, 2)
            v = cs._randn(gen, (B, N, KV, D), bf16).transpose(1, 2)
            lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32,
                                device="cuda")
            mask = (torch.arange(N, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]

            def run(q=q, k=k, v=v, lens=lens):
                return da.decode_attention_cuda(q, k, v, lens)

            def lib(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
        long = N >= 2048
        reps, calls = (20, 10) if long else (300, 50)
        name = f"{kernel} H{H} D{D} {'T' if 'flash' in kernel else 'S'}{N}"
        out[name] = {
            "ms": cs._time_ms(run, reps),
            "device_ms": cs._device_ms(run, calls),
            "library_ms": cs._time_ms(lib, reps),
            "library_device_ms": cs._device_ms(lib, calls),
        }
    if only in (None, "queue"):
        queue_child(cs, out)
    if only in (None, "scans"):
        scans_child(cs, out)
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", required=True, type=pathlib.Path)
    ap.add_argument("--after", type=pathlib.Path, default=ROOT)
    ap.add_argument("--only", choices=("attention", "queue", "scans"))
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child.resolve(), args.only)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs: dict = {"before": [], "after": []}
    for label in ("before", "after", "after", "before"):
        tree = getattr(args, label).resolve()
        proc = subprocess.run([sys.executable, __file__, "--before", str(tree),
                               "--child", str(tree)]
                              + (["--only", args.only] if args.only else []),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{label}: {json.dumps(rec)}", flush=True)
        runs[label].append(rec)
    for label, recs in runs.items():
        for key in recs[0]:
            if key == "tree":
                continue
            med = {m: statistics.median(r[key][m] for r in recs)
                   for m in recs[0][key]}
            print(f"SUMMARY {label} {key} "
                  + " ".join(f"{m}={v:.6f}" for m, v in med.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
