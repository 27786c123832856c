"""Serving launcher: the DES-driven continuous-batching engine (PyTorch
port of :mod:`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b

The same arguments, request generator and printout as the JAX launcher,
plus ``--device``: the default is the CUDA card, and the launcher raises
without one.  The model is ``LM(cfg, attn_impl="pallas")`` — the
hand-written kernels, the JAX docstrings' choice for the real
accelerator: ``flash_attention`` and ``decode_attention`` for the
``gqa`` layers (M-RoPE ones too), ``flash_attention`` for the prefill of
``mla`` layers (their absorbed decode is plain torch, as JAX's), the
``rwkv6_scan`` and ``mamba_scan`` kernels in the prefill of ``rwkv`` and
``mamba`` layers; MoE FFNs run batched expert products (with capacity
at prefill, dropless at decode) — with random weights from ``--seed``.
Decoding takes text tokens, as JAX's engine does.  Full width runs only
on the card (stablelm-12b: 12.1 B parameters, 24.3 GB of bf16 weights;
rwkv6-1.6b: 1.58 B, 3.17 GB; deepseek-v2-lite-16b: 15.7 B, 31.4 GB);
the full 72-layer jamba-1.5-large-398b (398 B parameters) and the
80-layer qwen2-vl-72b fit no single card, and ``chip_smoke.py`` serves
their first two layers at full width through :func:`serve`.  ``--reduced`` is the small
same-family config the CPU tests use.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.serving.engine import ServingEngine

MAX_LEN = 256


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new", type=int, default=12)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-batch-len", type=int, default=4)
    p.add_argument("--arrival-gap", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def build_model(args: argparse.Namespace) -> LM:
    """The config named by ``--arch`` (``--reduced``), its weights drawn
    on the device from ``--seed``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no serving path")
    return LM(cfg, attn_impl="pallas", device=args.device).init(args.seed)


def serve(model: LM, args: argparse.Namespace) -> ServingEngine:
    """Submit ``--requests`` seeded requests, run the engine to the end,
    print the JAX launcher's report, and return the engine."""
    cfg = model.cfg
    engine = ServingEngine(
        model, max_slots=args.slots, max_len=MAX_LEN,
        max_batch_len=args.max_batch_len,
        arrival_lookahead=args.arrival_gap)

    rng = np.random.default_rng(args.seed)
    t = 0.0
    horizon = args.requests * args.arrival_gap + args.max_new * 4 + 64
    for rid in range(args.requests):
        plen = int(rng.integers(4, 17))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        engine.submit(rid, prompt, args.max_new, at=t)
        t += args.arrival_gap + float(rng.random())
    engine.schedule_decode_grid(1.0, horizon)

    stats = engine.run()
    done = sum(1 for r in engine.requests.values() if r.done)
    print(f"served {done}/{args.requests} requests in "
          f"{stats.wall_seconds:.2f}s wall")
    print(f"decode events: {stats.decode_events}  "
          f"fused batches: {stats.fused_batches} "
          f"(mean len {stats.mean_fused_length:.2f})  "
          f"singles: {stats.singles}  prefills: {stats.prefills}")
    print(f"composed decode programs: "
          f"{sorted(k for k in stats.compiled_programs)}")
    for rid, r in sorted(engine.requests.items()):
        print(f"  req {rid}: arrived {r.arrival:.1f} "
              f"finished {r.finish_time:.1f} tokens={len(r.output)}")
    return engine


def main(argv=None) -> int:
    args = parse_args(argv)
    engine = serve(build_model(args), args)
    done = all(r.done for r in engine.requests.values())
    return 0 if done and len(engine.requests) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
