#!/usr/bin/env python3
"""``chip_smoke.py``'s phase ``devices`` alone, with its yardsticks.

    python3 scripts/torch_devices_phase.py

Builds ``queue_front.cu`` only, runs PHOLD at the smoke's sharded size
(917,504 LPs, a 1,048,576-slot tiered3 queue a shard, ``MODES_BATCHES``
super-steps) as phase ``queue_modes``' tiered3 run and phase
``sharded``'s (a) and (b) serial runs, then ``chip_smoke.run_devices``:
one NCCL rank in this process, four and two gloo ranks on the card.
Prints the yardsticks and the phase's lines; about three minutes on an
H100.  Needs a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    _build.build("queue_front")
    print(c.card_line(), flush=True)
    base, _, card_s, _, counts = c.run_phold_built("cuda", c.MODES_BATCHES)
    print(f"tiered3 {base.batches / card_s:.1f} steps/s {counts}", flush=True)
    hot = c.phold_hot_words(base)
    serial = {}
    for case, kw in (("a", dict(shards=c.SHARDS, validate="cheap")),
                     ("b", dict(shards=c.FUSED_SHARDS, dispatch_mode="fused",
                                hot_words=hot, **c.FUSED_SHARD_TIERS))):
        res, _, card_s, _, counts = c.run_phold_built(
            "cuda", c.MODES_BATCHES, **kw)
        problems = c.rows_problems(res, base)
        if problems:
            raise c.PhaseError(f"serial {case}: {problems}")
        serial[case] = (c.result_arrays(res), res.batches / card_s, counts)
        print(f"serial {case} {res.batches / card_s:.1f} steps/s {counts}",
              flush=True)
        del res
    c.run_devices(base, counts, serial, hot)
    print(f"seconds {time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
