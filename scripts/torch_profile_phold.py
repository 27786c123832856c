#!/usr/bin/env python3
"""Where a super-step of the PyTorch port's engine spends its time.

    python3 scripts/torch_profile_phold.py [--warm 2048] [--steps 256]

Runs the full-width PHOLD deployment of ``chip_smoke.py`` on the CUDA
card, advances it ``--warm`` super-steps (past the seeded front, where
the staging flushes and refills run), then:

1. times ``--steps`` more super-steps without the profiler (host clock
   around work that ends in a device synchronize);
2. traces the next ``--steps`` super-steps with ``torch.profiler``
   (CPU and CUDA activity) and reports the device's busy share (summed
   device-side activity — kernels, copies, fills — over the traced wall
   time), the device activities by time, and the host operators by call
   count per super-step (nested calls included).

Prints one JSON summary as its last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import queue as q
    from repro_torch.examples import phold

    prog = phold.build_program(
        num_lps=chip_smoke.PHOLD_LPS, t_stop=chip_smoke.PHOLD_T_STOP,
        max_batch_len=4, capacity=chip_smoke.PHOLD_CAPACITY)
    eng = prog.build(backend="device", device="cuda").engine
    queue = eng.initial_queue(prog.scheduled_events())
    state, queue, _ = eng.run(
        phold.initial_state(chip_smoke.PHOLD_LPS, "cuda"), queue,
        max_batches=args.warm)

    torch.cuda.synchronize()
    q.COUNTS.clear()
    t0 = time.perf_counter()
    state, queue, stats = eng.run(state, queue, max_batches=args.steps)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    counts = dict(q.COUNTS)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, queue, traced = eng.run(state, queue, max_batches=args.steps)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = prof.key_averages()
    # Device-side activities only: a host operator's entry carries the
    # device time of the kernels it launched too, so summing both
    # would count every kernel twice.
    device_us = {e.key: e.self_device_time_total for e in events
                 if str(e.device_type).endswith("CUDA")
                 and e.self_device_time_total > 0}
    host_calls = sorted(((e.count, e.key) for e in events
                         if e.key.startswith("aten::")), reverse=True)
    busy_us = sum(device_us.values())
    steps = traced["batches"]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "warm_steps": args.warm,
        "steps": stats["batches"],
        "untraced_ms_per_step": untraced_s * 1e3 / stats["batches"],
        "traced_ms_per_step": traced_s * 1e3 / steps,
        "device_busy_share": busy_us / (traced_s * 1e6),
        "device_us_per_step": busy_us / steps,
        "host_syncs_per_step": counts["host_syncs"] / stats["batches"],
        "rare_paths": {k: v for k, v in counts.items()
                       if k != "host_syncs"},
        "top_device_us_per_step": {
            k[:80]: v / steps for k, v in sorted(
                device_us.items(), key=lambda kv: -kv[1])[:12]},
        "top_aten_calls_per_step": {
            k: n / steps for n, k in host_calls[:15]},
        "aten_calls_per_step": sum(n for n, _ in host_calls) / steps,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
