#!/usr/bin/env python3
"""Where the queue wrappers' host time goes, at PHOLD's shapes.

    python3 scripts/torch_queue_host_cost.py [--rounds 31] [--calls 300]

Times, on the card, whole calls of ``window_extract_cuda`` (F 256, k 4,
W 4, one lookahead type) and ``front_merge_cuda`` (F 256, R 4, W 4), a
replica of each wrapper's body, and the replica with one step taken out
in turn: the plan lookup (the plan built once), the output allocations
(the outputs made once), the pointer array (built once from those) and
the launch (the ctypes call skipped); and the launch alone.  Each round
runs every variant ``--calls`` times back to back and synchronises; a
call's host time is the round's wall time over its calls (the kernels
take about 2 us of device time a call, which hides under the host's).
The variants take turns within each round.  Prints the median over
rounds of every variant, each step's cost as the replica's median less
the median without that step, and the steps' sum against the replica,
with the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import queue_front as qf  # noqa: E402
from repro_torch.kernels._build import launch_on  # noqa: E402

F, K, R, W = 256, 4, 4, 4
STEPS = ("lookup", "alloc", "ptrs", "launch")


def _front(gen, dev):
    live = 200
    times = torch.full((F,), float("inf"), device=dev)
    times[:live] = torch.sort(torch.rand(live, generator=gen,
                                         device=dev) * 8)[0]
    types = torch.full((F,), -1, dtype=torch.int32, device=dev)
    types[:live] = 0
    args = torch.rand((F, W), generator=gen, device=dev)
    seqs = torch.arange(F, dtype=torch.int32, device=dev)
    return [times, types, args, seqs], live


def window_variants(ops, dev):
    """name -> a call: the wrapper, its replica, the replica less each
    step, the launch alone."""
    lib = qf._lib().window_extract_launch
    plan = qf.window_extract_plan(*ops, None, k=K)
    f32, i32 = torch.float32, torch.int32

    def allocs():
        return (torch.empty(K, dtype=f32, device=dev),
                torch.empty(K, dtype=i32, device=dev),
                torch.empty(K, W, dtype=f32, device=dev),
                torch.empty((), dtype=i32, device=dev),
                torch.empty(F, dtype=f32, device=dev),
                torch.empty(F, dtype=i32, device=dev),
                torch.empty(F, W, dtype=f32, device=dev),
                torch.empty(F, dtype=i32, device=dev))

    fence = qf._open_fence(dev)

    def pointers(outs):
        return (ctypes.c_void_p * 15)(
            ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
            ops[3].data_ptr(), ops[4].data_ptr(), fence[0].data_ptr(),
            fence[1].data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
            outs[4].data_ptr(), outs[5].data_ptr(), outs[6].data_ptr(),
            outs[7].data_ptr())

    made = allocs()
    built = pointers(made)

    def replica(skip=None):
        def call():
            d, dims = (plan if skip == "lookup" else
                       qf.window_extract_plan(*ops, None, k=K))
            outs = made if skip == "alloc" else allocs()
            ptrs = built if skip == "ptrs" else pointers(outs)
            if skip != "launch":
                qf._launch_status("window_extract", launch_on(d, lib, ptrs,
                                                              *dims))
            return outs
        return call

    out = {"wrapper": lambda: qf.window_extract_cuda(*ops, None, k=K),
           "replica": replica()}
    out.update({f"no_{s}": replica(s) for s in STEPS})
    out["launch_only"] = lambda: launch_on(dev, lib, built, *plan[1])
    return out


def merge_variants(ops, dev):
    lib = qf._lib().front_merge_launch
    plan = qf.front_merge_plan(*ops)

    def allocs():
        return (torch.empty(F + R, dtype=torch.float32, device=dev),
                torch.empty(F + R, dtype=torch.int32, device=dev),
                torch.empty(F + R, W, dtype=torch.float32, device=dev),
                torch.empty(F + R, dtype=torch.int32, device=dev))

    def pointers(outs):
        return (ctypes.c_void_p * 14)(
            *(t.data_ptr() for t in ops), *(o.data_ptr() for o in outs))

    made = allocs()
    built = pointers(made)

    def replica(skip=None):
        def call():
            d, dims = plan if skip == "lookup" else qf.front_merge_plan(*ops)
            outs = made if skip == "alloc" else allocs()
            ptrs = built if skip == "ptrs" else pointers(outs)
            if skip != "launch":
                qf._launch_status("front_merge", launch_on(d, lib, ptrs,
                                                           *dims, 0))
            return outs
        return call

    out = {"wrapper": lambda: qf.front_merge_cuda(*ops), "replica": replica()}
    out.update({f"no_{s}": replica(s) for s in STEPS})
    out["launch_only"] = lambda: launch_on(dev, lib, built, *plan[1], 0)
    return out


def measure(variants: dict, rounds: int, calls: int) -> dict:
    """Median over rounds of each variant's host us a call."""
    per = {name: [] for name in variants}
    for fn in variants.values():       # warm: plans, allocator, build
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, fn in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            per[name].append((time.perf_counter() - t0) / calls * 1e6)
    med = {name: statistics.median(v) for name, v in per.items()}
    steps = {s: med["replica"] - med[f"no_{s}"] for s in STEPS}
    return {"us_per_call": med, "step_us": steps,
            "steps_sum_us": sum(steps.values()),
            "rest_us": med["replica"] - sum(steps.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=31)
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    front, live = _front(gen, dev)
    lookaheads = torch.tensor([1.0], device=dev)
    rows = [torch.rand(R, generator=gen, device=dev) * 8,
            torch.zeros(R, dtype=torch.int32, device=dev),
            torch.rand((R, W), generator=gen, device=dev),
            torch.arange(F, F + R, dtype=torch.int32, device=dev),
            torch.ones(R, dtype=torch.bool, device=dev)]
    front_n = torch.tensor(live, dtype=torch.int32, device=dev)
    for name, variants in (
            ("window_extract", window_variants(front + [lookaheads], dev)),
            ("front_merge", merge_variants(front + [front_n] + rows, dev))):
        rec = measure(variants, args.rounds, args.calls)
        print(f"HOST {name} {json.dumps(rec)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
