#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's LM spends its time.

    python3 scripts/torch_profile_serve.py [--arch stablelm-12b] [--steps 16]
    python3 scripts/torch_profile_serve.py --arch jamba-1.5-large-398b \
        --layers 2

Builds the serving model of ``repro_torch.launch.serve`` at full width on
the CUDA card (random weights from ``--seed``), or with ``--layers N``
the config cut to the first N layers of its block pattern (jamba's
first two are ``[(gqa, mlp), (mamba, moe)]``: the 72-layer model fits no
single card), prefills ``--slots``
seeded prompts of ``--prompt`` tokens into a ``max_len`` 256 cache, then:

1. times ``--steps`` decode steps of all slots without the profiler
   (host clock around work that ends in a device synchronize);
2. traces ``--steps`` more with ``torch.profiler`` (CPU and CUDA
   activity) and reports the device's busy share (summed device-side
   activity over the traced wall time), the device activities by time,
   and the host operators by call count per step;
3. times one prefill (``prefill`` then ``forward``, as the serving
   engine's prefill does) of one prompt.

Beside them it prints the step's weight-read bound: the bytes of every
parameter over 3.35 TB/s.  Prints one JSON summary as its last line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to the first N layers of its "
                         "block pattern")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.serving.engine import _splice_slot

    if args.layers is None:
        model = serve.build_model(serve.parse_args(
            ["--arch", args.arch, "--seed", str(args.seed)]))
    else:
        cfg = get_config(args.arch)
        cfg = dataclasses.replace(cfg, num_layers=args.layers,
                                  block_pattern=cfg.block_pattern[
                                      :args.layers])
        model = LM(cfg, attn_impl="pallas").init(args.seed)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    rng = np.random.default_rng(args.seed)
    prompts = torch.tensor(
        rng.integers(0, model.cfg.vocab_size, (args.slots, args.prompt)),
        dtype=torch.int32, device="cuda")
    cache = model.init_cache(args.slots, serve.MAX_LEN)
    for slot in range(args.slots):
        _, c1 = model.prefill(prompts[slot:slot + 1], max_len=serve.MAX_LEN)
        _splice_slot(cache, c1, slot)
    cache["lengths"].fill_(args.prompt)
    tokens = prompts[:, -1:].contiguous()

    def steps(cache, n):
        for _ in range(n):
            logits, cache = model.decode_step(cache, tokens)
        return cache

    cache = steps(cache, 2)                       # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = steps(cache, args.steps)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cache = steps(cache, args.steps)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = prof.key_averages()
    # Device-side activities only (a host operator's entry also carries
    # the device time of what it launched).
    device_us = {e.key: e.self_device_time_total for e in events
                 if str(e.device_type).endswith("CUDA")
                 and e.self_device_time_total > 0}
    host_calls = sorted(((e.count, e.key) for e in events
                         if e.key.startswith("aten::")), reverse=True)
    busy_us = sum(device_us.values())

    one = prompts[:1, :]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(one, max_len=serve.MAX_LEN)
    model.forward(one)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    n = args.steps
    summary = {
        "device": torch.cuda.get_device_name(0),
        "arch": model.cfg.name, "layers": model.cfg.num_layers,
        "slots": args.slots, "steps": n,
        "untraced_ms_per_step": untraced_s * 1e3 / n,
        "traced_ms_per_step": traced_s * 1e3 / n,
        "weight_read_bound_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
        "param_bytes": param_bytes,
        "device_busy_share": busy_us / (traced_s * 1e6),
        "device_us_per_step": busy_us / n,
        "top_device_us_per_step": {
            k[:80]: v / n for k, v in sorted(
                device_us.items(), key=lambda kv: -kv[1])[:12]},
        "top_aten_calls_per_step": {k: c / n for c, k in host_calls[:15]},
        "aten_calls_per_step": sum(c for c, _ in host_calls) / n,
        "prefill_plus_forward_ms": prefill_s * 1e3,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
