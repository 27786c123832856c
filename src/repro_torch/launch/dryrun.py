"""Multi-pod dry run (PyTorch port of :mod:`repro.launch.dryrun`).

Proves the distribution config is coherent without hardware: every
(architecture × applicable input shape × mesh) cell is built on the
16×16 single-pod mesh and the 2×16×16 multi-pod mesh of
:mod:`repro_torch.launch.mesh`, each over a fake process group of 256
or 512 ranks (torch's ``"fake"`` backend: this process is rank 0, and
the collectives move nothing).  JAX's "lower and compile" is "build the
``DTensor`` avatars by the sharding rules and trace the step": the
avatars are fake tensors (no memory), and
:mod:`repro_torch.launch.graph_cost` counts each device's FLOPs, bytes,
collective bytes and peak live bytes on its shards, which
:mod:`repro_torch.launch.roofline` prices at H100 rates.  Each cell
records its status, trace seconds, ``static_info``, the per-device
roofline and ``attention_score_hbm_bytes_total``, as JAX's does, into a
JSON file (``--out``); a ``FAILED`` cell makes the run exit 1.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun           # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k --mesh multi                            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --out results.json --jobs 8

The avatars are CUDA tensors unless ``--device cpu`` is given: their
device picks the model's route (bf16 products in bf16 on the card, in
f32 on the CPU), so a CUDA build of torch and a card must be present.
``--jobs N`` traces N cells at once, each in a process of its own (a
process holds one default process group).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

DEFAULT_OUT = "dryrun_results.json"
MESHES = {"single": (256, False), "multi": (512, True)}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             attn_impl: str = "blockwise", fsdp: bool = True, device=None,
             verbose: bool = True, reduced: bool = False,
             mesh_shape: tuple | None = None,
             shape: dict | None = None) -> dict:
    """One cell on its production mesh over a fake process group of the
    mesh's size (``mesh_shape``, with JAX's axis names, and ``reduced``
    and ``shape`` cut a cell down for tests)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import shape_applicable
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import (
        fake_process_group,
        make_production_mesh,
    )
    from repro_torch.launch.specs import build_cell

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    world, multi = MESHES[mesh_name]
    if mesh_shape is not None:
        world = 1
        for n in mesh_shape:
            world *= n
    with fake_process_group(world):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi, device=device)
        else:
            from torch.distributed.device_mesh import init_device_mesh

            from repro_torch.launch.mesh import _device_type

            mesh = init_device_mesh(
                _device_type(device), mesh_shape,
                mesh_dim_names=(("pod",) if multi else ()) + ("data",
                                                              "model"))
        t0 = time.perf_counter()
        cell = build_cell(cfg, shape_name, mesh, shape=shape, device=device,
                          attn_impl=attn_impl, fsdp=fsdp)
        spec = cell.shape_spec
        roof = rl.analyze(cell, mesh_name=mesh_name)
        t_trace = time.perf_counter() - t0
    score_bytes = rl.attention_score_hbm_bytes(
        cfg, cell.kind, spec["global_batch"], spec["seq_len"])
    mem_adj = max(0.0, roof.memory_seconds
                  - score_bytes / roof.chips / rl.HBM_BW)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "kind": cell.kind,
        "trace_seconds": round(t_trace, 2),
        "static_info": cell.static_info,
        "roofline": {**roof.to_dict(), "bound_seconds": roof.bound_seconds},
        "memory_seconds_pallas_adj": mem_adj,
        "attention_score_hbm_bytes_total": score_bytes,
    }
    if verbose:
        ms = roof.memory_stats
        print(f"[{arch} × {shape_name} × {mesh_name}] OK "
              f"trace={t_trace:.1f}s "
              f"args={ms['argument_bytes'] / 1e9:.2f}GB/dev "
              f"temp={ms['temp_bytes'] / 1e9:.2f}GB/dev "
              f"compute={roof.compute_seconds * 1e3:.2f}ms "
              f"memory={roof.memory_seconds * 1e3:.2f}ms "
              f"collective={roof.collective_seconds * 1e3:.2f}ms "
              f"dominant={roof.dominant} mfu@bound={roof.mfu:.3f}",
              flush=True)
    return result


def _guarded(arch, shape_name, mesh_name, kw) -> dict:
    """:func:`run_cell`, a failure recorded as ``FAILED`` (a system bug)."""
    try:
        return run_cell(arch, shape_name, mesh_name, **kw)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "FAILED", "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> None:
    from repro_torch.configs import SHAPES, list_configs

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, help="one arch id (default all)")
    p.add_argument("--shape", default=None, choices=list(SHAPES),
                   help="one shape (default all)")
    p.add_argument("--mesh", default=None, choices=list(MESHES),
                   help="one mesh (default both)")
    p.add_argument("--attn-impl", default="blockwise")
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--append", action="store_true",
                   help="merge into an existing results file")
    p.add_argument("--device", default=None,
                   help="the avatars' device (default: the CUDA card)")
    p.add_argument("--jobs", type=int, default=1,
                   help="cells traced at once, a process each")
    args = p.parse_args(argv)

    archs = [args.arch] if args.arch else list_configs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else list(MESHES)

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    # re-attempt FAILED cells on resume; keep ok/skipped
    results = [r for r in results if r["status"] != "FAILED"]
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    todo = [(a, s, m) for a in archs for s in shapes for m in meshes
            if (a, s, m) not in done]
    # the train cells, the longest to trace, first
    kinds = ["train", "prefill", "decode"]
    todo.sort(key=lambda cell: kinds.index(SHAPES[cell[1]]["kind"]))
    kw = dict(attn_impl=args.attn_impl, fsdp=not args.no_fsdp,
              device=args.device)

    def record(r) -> None:
        if r["status"] == "skipped":
            print(f"[{r['arch']} × {r['shape']} × {r['mesh']}] "
                  f"skipped: {r['reason']}", flush=True)
        results.append(r)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                max_workers=args.jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            for fut in [pool.submit(_guarded, *cell, kw) for cell in todo]:
                record(fut.result())
    else:
        for cell in todo:
            record(_guarded(*cell, kw))
    failures = sum(1 for r in results if r["status"] == "FAILED")
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    print(f"\ndry-run complete: {ok} ok, {sk} skipped, {failures} FAILED "
          f"-> {args.out}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
