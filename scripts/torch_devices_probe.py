#!/usr/bin/env python3
"""Which ``all_gather`` forms a process group takes for CUDA tensors on
this host's card, and what a small gather costs.

    python3 scripts/torch_devices_probe.py

The sharded engine's ``placement="devices"`` gathers every super-step
(``repro_torch.core.queue.all_gather_rows``).  On one card several
ranks can share only a gloo group (NCCL refuses two ranks on one
device).  This starts, for each check, 4 gloo ranks on ``cuda:0`` (each
a child process at ``tcp://localhost:<free port>``) and prints each
rank 0's outcome: the list form of ``all_gather`` and
``all_gather_into_tensor`` on CPU and on CUDA tensors, ``broadcast`` on
a CUDA tensor, a barrier, a 1-D ``"shards"`` ``DeviceMesh`` of device
type ``cuda``, and the milliseconds of a list-form gather of a
``[4, 7]`` int32 slab (a PHOLD head slab) on the CPU and staged through
the host from the card.  Needs a CUDA device.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

WORLD = 4
CHECKS = ("cpu_list,cpu_into,barrier,timing,mesh", "cuda_bcast", "cuda_list",
          "cuda_into")


def _rank(rank: int, port: int, checks: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    dev = torch.device("cuda:0")
    xc = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 100 * rank

    def gather_list(x):
        parts = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(parts, x)
        return torch.cat(parts).flatten().tolist()

    def gather_into(x):
        out = torch.empty((2 * WORLD, 3), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out.flatten().tolist()

    def bcast():
        x = xc.to(dev)
        dist.broadcast(x, 0)
        return x.flatten().tolist()

    def mesh():
        from torch.distributed.device_mesh import init_device_mesh

        return str(init_device_mesh("cuda", (WORLD,),
                                    mesh_dim_names=("shards",)))

    def timing(reps=300):
        h = torch.zeros((4, 7), dtype=torch.int32)
        parts = [torch.empty_like(h) for _ in range(WORLD)]
        for _ in range(20):
            dist.all_gather(parts, h)
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_gather(parts, h)
        cpu_ms = (time.perf_counter() - t0) / reps * 1e3
        hd = h.to(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_gather(parts, hd.cpu())
            torch.cat(parts).to(dev)
        torch.cuda.synchronize()
        staged_ms = (time.perf_counter() - t0) / reps * 1e3
        return dict(cpu_ms=cpu_ms, staged_ms=staged_ms)

    runs = dict(cpu_list=lambda: gather_list(xc),
                cpu_into=lambda: gather_into(xc),
                cuda_list=lambda: gather_list(xc.to(dev)),
                cuda_into=lambda: gather_into(xc.to(dev)),
                cuda_bcast=bcast, barrier=dist.barrier, mesh=mesh,
                timing=timing)
    for name in checks.split(","):
        try:
            out = runs[name]()
            torch.cuda.synchronize()
            print(f"[{rank}] ok {name} {out}", flush=True)
        except Exception as e:  # noqa: BLE001 -- reported, not raised
            print(f"[{rank}] fail {name} {type(e).__name__}: {e}", flush=True)
    dist.destroy_process_group()


def main() -> None:
    for checks in CHECKS:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), str(port), checks],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        print(f"== {checks}: exit codes {[p.returncode for p in procs]}")
        print("\n".join(line for line in outs[0].splitlines()
                        if line.startswith("[0]")), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
