#!/usr/bin/env python3
"""What one rank of ``placement="devices"`` costs a super-step over the
serial engine at one shard, on an NCCL group of one rank.

    python3 scripts/torch_profile_devices.py

Times ``repro_torch.core.queue.all_gather_rows`` of a PHOLD head slab
(``[4, 7]`` int32) and of a guard summary (``[1, 2]``), without and
with a host read after each; then, for the serial engine and the
devices placement at one shard (PHOLD at 917,504 LPs, a 1,048,576-slot
queue), 64 warm-up super-steps and 256 timed ones (host clock around
work that ends in a device synchronize); and 128 more of the devices
placement under ``cProfile``, its host functions by own time.  Needs a
CUDA device.
"""

from __future__ import annotations

import cProfile
import pathlib
import pstats
import socket
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

LPS = 917_504
CAPACITY = 1_048_576


def main() -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core import queue as q
    from repro_torch.examples import phold

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        for shape in ((4, 7), (1, 2)):
            t = torch.zeros(shape, dtype=torch.int32, device="cuda")
            for read in (False, True):
                for _ in range(20):
                    q.all_gather_rows(t, group)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(300):
                    r = q.all_gather_rows(t, group)
                    if read:
                        r[0, 0].item()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 300 * 1e3
                print(f"gather {shape} {'read' if read else 'no read'}: "
                      f"{ms:.6f} ms", flush=True)
        for kw in ({}, {"placement": "devices"}):
            sim = phold.build_program(
                num_lps=LPS, t_stop=4194304.0, max_batch_len=4,
                capacity=CAPACITY).build(device="cuda", shards=1, **kw)
            eng = sim.engine
            state, queue, stats = eng.run(
                phold.initial_state(LPS, "cuda"),
                eng.initial_queue(sim.program.scheduled_events()),
                max_batches=64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, queue, stats = eng.run(state, queue, max_batches=320,
                                          stats=stats)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 256 * 1e3
            print(f"{kw or 'serial'}: {ms:.6f} ms a super-step", flush=True)
        prof = cProfile.Profile()
        prof.enable()
        eng.run(state, queue, max_batches=448, stats=stats)
        torch.cuda.synchronize()
        prof.disable()
        pstats.Stats(prof).sort_stats("tottime").print_stats(18)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
