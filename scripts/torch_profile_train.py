#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time.

    python3 scripts/torch_profile_train.py [--arch granite-moe-1b-a400m]
        [--batch 8] [--seq-len 1024] [--microbatches 2] [--remat]
        [--layers N]

Builds ``LM(cfg)`` at full width on the CUDA card (``--layers N`` cuts
the depth to N layers), its train state from seed 0
(``init_train_state``) and ``make_train_step`` with cosine AdamW at
3e-4, then:

1. times two steps without the profiler after one warm-up step (host
   clock around a step ended by a device synchronize);
2. traces one more step with ``torch.profiler`` (CPU and CUDA activity)
   and reports the device's busy share (summed device-side activity over
   the traced wall time), the device activities by time, the aten
   operators by the device time of what they launched, and the aten
   calls a step;
3. times ``adamw_update`` alone on the state (f32 zero gradients of the
   params' shapes: the same work as a step's update).

Prints one JSON summary as its last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import LM
    from repro_torch.training.optim import AdamWConfig, adamw_update
    from repro_torch.training.train_step import (
        init_train_state,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = LM(cfg)
    state = init_train_state(model, 0)
    opt_cfg = AdamWConfig(lr=3e-4, schedule="cosine")
    step = make_train_step(model, opt_cfg,
                           num_microbatches=args.microbatches,
                           remat=args.remat)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch)
    batches = [make_batch(dc, i, model.device) for i in range(4)]

    state, _ = step(state, batches[0])            # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:3]:
        state, metrics = step(state, b)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / 2

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[3])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_us = {e.key: e.self_device_time_total for e in events
                 if str(e.device_type).endswith("CUDA")
                 and e.self_device_time_total > 0}
    aten_device = {e.key: e.device_time_total for e in events
                   if e.key.startswith("aten::") and e.device_time_total}
    aten_calls = sum(e.count for e in events if e.key.startswith("aten::"))
    busy_us = sum(device_us.values())

    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device),
                     state["params"])
    adamw_update(opt_cfg, state["params"], grads, state["opt"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adamw_update(opt_cfg, state["params"], grads, state["opt"])
    torch.cuda.synchronize()
    optimizer_ms = (time.perf_counter() - t0) * 1e3

    tokens = args.batch * args.seq_len
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": cfg.name,
        "layers": cfg.num_layers, "batch": args.batch,
        "seq_len": args.seq_len, "microbatches": args.microbatches,
        "remat": args.remat, "loss": float(metrics["loss"]),
        "untraced_ms_per_step": untraced_ms,
        "tokens_per_s": tokens / untraced_ms * 1e3,
        "traced_ms_per_step": traced_ms,
        "device_busy_share": busy_us / (traced_ms * 1e3),
        "device_ms_per_step": busy_us / 1e3,
        "optimizer_ms": optimizer_ms,
        "top_device_ms": {k[:90]: v / 1e3 for k, v in sorted(
            device_us.items(), key=lambda kv: -kv[1])[:15]},
        "top_aten_device_ms": {k: v / 1e3 for k, v in sorted(
            aten_device.items(), key=lambda kv: -kv[1])[:15]},
        "aten_calls_per_step": aten_calls,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
