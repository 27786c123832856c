"""Roofline of a cell on NVIDIA H100 SXM5 80GB cards (PyTorch port of
:mod:`repro.launch.roofline`, which prices XLA's HLO at TPU v5e rates;
none of those carries over).

Terms, per device, at datasheet rates:

    compute    = sum over dtypes of product FLOPs / that dtype's peak
                 (989e12 FLOP/s dense bf16/fp16 tensor cores, 67e12 f32)
    memory     = bytes / 3.35e12 B/s (HBM3)
    collective = sum over the collectives' groups of their operand bytes
                 / the slowest link the group spans: NVLink 4 within an
                 8-card HGX H100 node (450e9 B/s each way a card), 400
                 Gb/s NDR InfiniBand across nodes (50e9 B/s a card).
                 The ranks of a mesh fill the nodes in order, 8 a node.

The FLOPs, bytes and collective bytes come from
:mod:`repro_torch.launch.graph_cost` (the aten operations of the cell's
step on fake tensors, the eager port's traffic; per device on a mesh),
the model FLOPs from the same analytic ``6·N·D`` (train) or ``2·N·D``
(inference) as JAX's, N the active parameters.  ``mfu`` is the model
FLOPs over the bound's seconds at the bf16 peak: a whole step's
model-FLOPs share at the roofline; with a measured step time in place of
the bound it is the measured share.  The memory stats are per device:
the avatars' argument, output and donated bytes (each rank's shards),
and ``temp_bytes``, the peak of the bytes the step's own tensors hold
alive (the counterpart of XLA's ``memory_analysis()`` temp bytes).

    python -m repro_torch.launch.roofline --arch stablelm-12b \\
        --shape decode_32k [--device cpu] [--reduced]
    python -m repro_torch.launch.roofline --all

``--all`` prints one JSON line a cell for every (arch x shape) cell that
``shape_applicable`` admits, one device, each traced in a worker
process, with its trace seconds (the mesh's cells are
:mod:`repro_torch.launch.dryrun`'s).  The avatars hold no memory, but
their device picks the model's route: on CUDA avatars (the default; the
CUDA build of torch and a card must be present) bf16 products run in
bf16 with f32 accumulation, as on the card, while ``--device cpu``
counts the CPU route, which upcasts their operands to f32 (the same
FLOPs, more bytes, priced at the f32 rate).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BF16 = PEAK_FLOPS["bfloat16"]
HBM_BW = 3.35e12             # bytes/s, one card
# Link rates, datasheet, bytes/s each way a card: NVLink 4 within an
# 8-card HGX H100 node; 400 Gb/s NDR InfiniBand (one port a card) across
# nodes.
LINK_BW = {"nvlink": 450e9, "infiniband": 400e9 / 8}
CARDS_PER_NODE = 8


def _tree_bytes(tree) -> int:
    """Per-device bytes of a tree's tensors (a ``DTensor``'s local
    shard)."""
    import torch
    from torch.utils._pytree import tree_leaves

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    return sum(local(x).numel() * local(x).element_size()
               for x in tree_leaves(tree) if torch.is_tensor(x))


def link_rate(mesh_shape: tuple, mesh_axes: tuple, group: str) -> float:
    """The slowest link a collective over the mesh axes ``group``
    (comma-joined) spans: NVLink when its ranks share a node, else
    InfiniBand.  Ranks fill the mesh in row-major order."""
    axes = [a for a in group.split(",") if a]
    strides, n = {}, 1
    for name, size in reversed(list(zip(mesh_axes, mesh_shape))):
        strides[name] = n
        n *= size
    last = sum(strides[a] * (size - 1)
               for a, size in zip(mesh_axes, mesh_shape) if a in axes)
    return LINK_BW["nvlink" if last // CARDS_PER_NODE == 0 else "infiniband"]


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_detail: dict
    model_flops: float           # 6·N(active)·D analytic
    memory_stats: dict
    # Product FLOPs by operand dtype; None prices all at the bf16 peak.
    flops_by_dtype: dict | None = None
    # Collective operand bytes by the mesh axes of the group, and the
    # mesh they price on.
    collective_by_group: dict = dataclasses.field(default_factory=dict)
    mesh_shape: tuple = ()
    mesh_axes: tuple = ()

    @property
    def compute_seconds(self) -> float:
        """Each dtype's products at its peak; a dtype without a tensor
        core rate (f64, integers) at the f32 one."""
        if self.flops_by_dtype is None:
            return self.flops_per_device / PEAK_BF16
        return sum(n / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                   for dt, n in self.flops_by_dtype.items())

    @property
    def memory_seconds(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_seconds(self) -> float:
        """Each group's operand bytes over the slowest link it spans."""
        return sum(n / link_rate(self.mesh_shape, self.mesh_axes, g)
                   for g, n in self.collective_by_group.items())

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_seconds,
            "memory": self.memory_seconds,
            "collective": self.collective_seconds,
        }
        return max(terms, key=terms.get)

    @property
    def bound_seconds(self) -> float:
        return max(self.compute_seconds, self.memory_seconds,
                   self.collective_seconds)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / traced FLOPs: remat and redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline bound (useful flops /
        card-seconds at the bound, at the bf16 peak)."""
        return self.mfu_at(self.bound_seconds)

    def mfu_at(self, seconds: float) -> float:
        """The model-FLOPs share of a step that takes ``seconds``."""
        denom = seconds * self.chips * PEAK_BF16
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "flops_by_dtype": self.flops_by_dtype,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_detail": self.collective_detail,
            "collective_by_group": self.collective_by_group,
            "model_flops": self.model_flops,
            "compute_seconds": self.compute_seconds,
            "memory_seconds": self.memory_seconds,
            "collective_seconds": self.collective_seconds,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_at_bound": self.mfu,
            "memory_stats": self.memory_stats,
        }


def model_flops_for(cfg, kind: str, tokens: int, seq_len: int) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for train, 2·N·D for inference
    (forward only), N = active params for MoE."""
    n = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def attention_score_hbm_bytes(cfg, kind: str, batch: int,
                              seq_len: int) -> float:
    """Analytic HBM traffic of materialized attention score blocks: the
    plain blockwise attention writes each fp32 score and probability
    block between its two products, where the flash kernel keeps them
    on chip.  s write + s read + p write + p read = 4 touches x fp32 per
    (B, H, T, S) element; causal halves; train ≈ 3 passes (fwd + remat
    fwd + bwd), prefill 1.  Attention layers only."""
    n_attn = 0
    for pattern, repeat in cfg.stages():
        for spec in pattern:
            if spec.mixer in ("gqa", "mla"):
                n_attn += repeat
    if kind == "decode" or n_attn == 0:
        return 0.0
    passes = 3.0 if kind == "train" else 1.0
    causal = 0.5 if cfg.causal else 1.0
    elems = float(batch) * cfg.num_heads * seq_len * seq_len
    return n_attn * passes * causal * elems * 4.0 * 4.0  # 4 touches, fp32


def analyze(cell, *, cost=None, model_flops: float | None = None,
            mesh_name: str | None = None) -> Roofline:
    """The :class:`Roofline` of a :class:`~repro_torch.launch.specs.
    CellSpec`, per device of its mesh (one card without): ``cost``
    (default :func:`~repro_torch.launch.graph_cost.cell_cost`, the full
    cell extended from cut traces) and the model FLOPs of the cell's
    tokens.  The output bytes count the outputs' avatars at the
    arguments' placements (a one-device cell's, or the donated state's
    and cache's own)."""
    from repro_torch.launch.graph_cost import cell_cost

    cost = cell_cost(cell) if cost is None else cost
    if model_flops is None:
        model_flops = model_flops_for(cell.cfg, cell.kind,
                                      cell.static_info["tokens"],
                                      cell.shape_spec["seq_len"])
    mesh = cell.mesh
    chips = mesh.size() if mesh is not None else 1
    mem = {
        "argument_bytes": _tree_bytes(cell.arg_specs),
        "output_bytes": _tree_bytes(cell.out_specs),
        "alias_bytes": _tree_bytes([cell.arg_specs[i]
                                    for i in cell.donate_argnums]),
        "temp_bytes": cost.peak_bytes,
    }
    return Roofline(
        arch=cell.arch, shape=cell.shape,
        mesh=mesh_name or ("single" if mesh is None else
                           "x".join(map(str, mesh.shape))),
        chips=chips, flops_per_device=cost.flops,
        bytes_per_device=cost.mem_bytes,
        collective_bytes_per_device=cost.coll_bytes,
        collective_detail=cost.coll_by_op, model_flops=model_flops,
        memory_stats=mem, flops_by_dtype=dict(cost.flops_by_dtype),
        collective_by_group=dict(cost.coll_by_group),
        mesh_shape=tuple(mesh.shape) if mesh is not None else (),
        mesh_axes=tuple(mesh.mesh_dim_names) if mesh is not None else ())


def _sweep_cell(arch: str, shape: str, device) -> dict:
    """One cell's roofline and trace seconds (a ``--all`` worker)."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import build_cell

    t0 = time.perf_counter()
    r = analyze(build_cell(get_config(arch), shape, device=device))
    return {**r.to_dict(), "bound_seconds": r.bound_seconds,
            "trace_s": time.perf_counter() - t0}


def sweep(*, device=None):
    """Yield the roofline of every applicable cell, traced in up to 8
    processes, in cell order."""
    import concurrent.futures
    import multiprocessing
    import os

    from repro_torch.configs import SHAPES, get_config, list_configs
    from repro_torch.configs.base import shape_applicable

    cells = [(arch, shape) for arch in list_configs() for shape in SHAPES
             if shape_applicable(get_config(arch), shape)[0]]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(_sweep_cell, arch, shape, device)
                for arch, shape in cells]
        for fut in futs:
            yield fut.result()


def main(argv=None) -> None:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.specs import build_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every applicable full-size cell, one JSON "
                         "line a cell")
    ap.add_argument("--device", default=None,
                    help="the avatars' device (default: the CUDA card)")
    ap.add_argument("--reduced", action="store_true",
                    help="the small same-family config (one cell)")
    args = ap.parse_args(argv)
    if args.all:
        for row in sweep(device=args.device):
            print(json.dumps(row), flush=True)
        return
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cell = build_cell(cfg, args.shape, device=args.device)
    print(json.dumps(analyze(cell).to_dict(), indent=1))


if __name__ == "__main__":
    main()
