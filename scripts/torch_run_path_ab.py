#!/usr/bin/env python3
"""Time the engine's run path of two checkouts on one card, in turns.

    python3 scripts/torch_run_path_ab.py --before DIR [--after DIR]
        [--calls N]

``DIR`` is the root of a checkout of the repository (for example an
unpacked ``git archive`` of the parent commit); ``--after`` defaults to
this script's own checkout.  One child process per checkout runs in the
order before, after, after, before, so that both meet the card in the
same states.  A child imports ``repro_torch`` and ``chip_smoke.py`` from
its checkout and measures:

- ``handler_ms``: one call of the masked run handler that its engine
  built for M/M/c's entity-parallel TALLY type (6 leaves of 65,536
  stations, 4 real lanes), back to back, per call, ``--calls`` calls
  after 50 warm-up calls;
- ``chip_smoke.py``'s phase ``mmc`` of that checkout, whole: each line
  is printed, and the full-size runs' ``card_steps_per_s`` per dispatch
  mode are kept (1,024 super-steps, almost all on the run path).

Prints one JSON line per child and one summary line per checkout and
metric (the median over its children), with the card's ``nvidia-smi``
name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def child(root: pathlib.Path, calls: int) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.core import ARG_WIDTH
    from repro_torch.examples import mmc_network as mmc

    STATIONS = cs.MMC_STATIONS
    out = {"root": str(root)}
    sim = mmc.build_program(
        num_stations=STATIONS, t_open=cs.MMC_T_OPEN,
        max_batch_len=cs.MMC_BATCH_LEN, capacity=cs.MMC_CAPACITY).build(
            backend="device", device="cuda")
    (handler,) = sim.engine._run_branches.values()
    state = mmc.initial_state(STATIONS, "cuda")
    ids = torch.tensor([3, 1000, 40000, STATIONS - 1], dtype=torch.int32,
                       device="cuda")
    mask = torch.ones(4, dtype=torch.bool, device="cuda")
    ts = torch.zeros(4, device="cuda")
    args = torch.zeros((4, ARG_WIDTH), device="cuda")
    for _ in range(50):
        handler(state, ts, args, ids, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        handler(state, ts, args, ids, mask)
    torch.cuda.synchronize()
    out["handler_ms"] = (time.perf_counter() - t0) * 1e3 / calls

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cs.run_mmc("cuda")
    for line in buf.getvalue().splitlines():
        print(line, file=sys.stderr)
        fields = dict(f.split("=", 1) for f in line.split()[1:]
                      if "=" in f)
        if line.startswith("PHASE mmc ") and fields.get("batches") == "1024":
            out[f"{fields['mode']}_steps_per_s"] = float(
                fields["card_steps_per_s"])
            out[f"{fields['mode']}_run_path"] = int(fields["run_path"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", type=pathlib.Path)
    ap.add_argument("--after", type=pathlib.Path, default=ROOT)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child is not None:
        print(json.dumps(child(a.child.resolve(), a.calls)))
        return 0
    if a.before is None:
        ap.error("--before is required")
    import torch

    if not torch.cuda.is_available():
        print("torch_run_path_ab: no CUDA device is available",
              file=sys.stderr)
        return 2
    rows = {"before": [], "after": []}
    for label in ("before", "after", "after", "before"):
        root = getattr(a, label).resolve()
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(root),
             "--calls", str(a.calls)],
            capture_output=True, text=True, cwd=root)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"torch_run_path_ab: {label} child failed "
                  f"(exit {proc.returncode})", file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        got["label"] = label
        print(json.dumps(got))
        rows[label].append(got)
    for label, runs in rows.items():
        for key in sorted(runs[0]):
            if key in ("root", "label"):
                continue
            vals = [r[key] for r in runs]
            print(f"SUMMARY {label} {key} median={statistics.median(vals)} "
                  f"runs={vals}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
