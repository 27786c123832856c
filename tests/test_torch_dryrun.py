"""The dry run's per-device counts (``repro_torch.launch.graph_cost`` on
``DTensor`` avatars over a fake process group) and
``repro_torch.launch.dryrun.run_cell`` against JAX's.

* A matrix product sharded so that nothing is replicated: the per-device
  FLOPs times the 256 ranks of a fake (16, 16) group equal the global
  product's, and no collective is counted.
* Known redistributions: an all-gather over ``data`` and an all-reduce
  over ``model`` count their operand bytes per device, by op and by the
  mesh axis of their group; ``wait_tensor`` counts nothing.
* A reduced cell of each kind (train, prefill, decode) runs through
  ``run_cell`` on a fake (2, 2, 2) ("pod", "data", "model") mesh, with
  collective bytes wherever its placements force a collective, and its
  per-device argument bytes equal JAX's ``memory_analysis().
  argument_size_in_bytes`` for the same cell compiled on 8 fake host
  devices (a child process).  Its per-device FLOPs times 8 are at least
  the cell's count without a mesh (no local work goes uncounted), and
  equal to it for a dense model, whose layout replicates no product:
  stablelm's train, prefill and decode cells.  (At these sizes granite's
  MoE groups straddle the batch shards, so every rank routes all the
  tokens, and jamba's B=1 runs whole on every DP rank.)
Tolerance: exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import (
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.launch import dryrun
from repro_torch.launch.graph_cost import trace_cost
from repro_torch.launch.mesh import fake_process_group, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
# (arch, shape name, the reduced cell's batch and length)
CELLS = [("stablelm-12b", "train_4k", 4, 32),
         ("granite-moe-1b-a400m", "prefill_32k", 8, 32),
         ("jamba-1.5-large-398b", "long_500k", 1, 64)]
# Cells whose layout on (2, 2, 2) replicates no product.
DENSE = [("stablelm-12b", "train_4k", 4, 32),
         ("stablelm-12b", "prefill_32k", 8, 32),
         ("stablelm-12b", "decode_32k", 4, 64)]


def _shape(shape_name: str, B: int, T: int) -> dict:
    from repro_torch.configs import SHAPES

    return dict(SHAPES[shape_name], global_batch=B, seq_len=T)


def _one_device_flops(arch: str, shape_name: str, B: int, T: int) -> float:
    """The reduced cell's FLOPs traced without a mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.specs import build_cell

    cell = build_cell(get_config(arch).reduced(), shape_name, None,
                      shape=_shape(shape_name, B, T), device="cpu")
    return roofline.analyze(cell, mesh_name="single").flops_per_device


def test_matmul_flops_per_device_times_ranks_is_global():
    with fake_process_group(256):
        mesh = make_production_mesh(device="cpu")
        mode = FakeTensorMode()
        with mode:
            x = distribute_tensor(torch.empty(256, 128, 4096), mesh,
                                  [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(4096, 4096), mesh,
                                  [Replicate(), Shard(1)])
        cost = trace_cost(lambda a, b: torch.einsum("btd,df->btf", a, b),
                          x, w, fake_mode=mode)
    assert cost.flops * 256 == 2.0 * 256 * 128 * 4096 * 4096
    assert cost.coll_bytes == 0 and cost.coll_by_op == {}


def test_redistribute_collective_bytes_are_their_operands():
    with fake_process_group(256):
        mesh = make_production_mesh(device="cpu")
        mode = FakeTensorMode()
        with mode:
            w = distribute_tensor(torch.empty(4096, 4096,
                                              dtype=torch.bfloat16),
                                  mesh, [Shard(0), Shard(1)])
            p = torch.distributed.tensor.DTensor.from_local(
                torch.empty(64, 1024), mesh, [Replicate(), Partial()],
                run_check=False)

        def step(w, p):
            return (w.redistribute(mesh, [Replicate(), Shard(1)]),
                    p.redistribute(mesh, [Replicate(), Replicate()]))

        cost = trace_cost(step, w, p, fake_mode=mode)
    shard = (4096 // 16) * (4096 // 16) * 2          # the local bf16 block
    reduce = 64 * 1024 * 4
    assert cost.coll_by_op == {
        "all_gather_into_tensor": {"bytes": shard, "count": 1},
        "all_reduce": {"bytes": reduce, "count": 1}}
    assert cost.coll_by_group == {"data": shard, "model": reduce}
    assert cost.coll_bytes == shard + reduce
    assert cost.flops == 0


def _write_jax_argument_bytes(path: str) -> None:
    """JAX's per-device argument bytes of each reduced cell on a (2, 2, 2)
    mesh of 8 host devices."""
    import jax

    from repro.configs import base as jbase
    from repro.configs import get_config
    from repro.launch.specs import build_cell

    # jax.make_mesh's explicit axes refuse the model's sharding
    # constraints under jax 0.9; jax.sharding.Mesh's are automatic
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2, 2),
                             ("pod", "data", "model"))
    out = {}
    for arch, shape_name, B, T in CELLS:
        jbase.SHAPES[shape_name] = dict(jbase.SHAPES[shape_name],
                                        global_batch=B, seq_len=T)
        cell = build_cell(get_config(arch).reduced(), shape_name, mesh)
        with mesh:
            compiled = jax.jit(
                cell.fn, in_shardings=cell.in_shardings,
                out_shardings=cell.out_shardings,
                donate_argnums=cell.donate_argnums,
            ).lower(*cell.arg_specs).compile()
        out[arch] = compiled.memory_analysis().argument_size_in_bytes
    with open(path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def jax_argument_bytes(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dryrun") / "args.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_dryrun as t; "
            "t._write_jax_argument_bytes(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape_name,B,T", CELLS,
                         ids=[c[1] for c in CELLS])
def test_reduced_cell_on_a_fake_2x2x2_mesh(arch, shape_name, B, T,
                                           jax_argument_bytes):
    r = _meshed(arch, shape_name, B, T)
    assert r["status"] == "ok"
    roof = r["roofline"]
    assert roof["chips"] == 8
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    one = _one_device_flops(arch, shape_name, B, T)
    if (arch, shape_name, B, T) in DENSE:
        assert roof["flops_per_device"] * 8 == one
    else:
        assert roof["flops_per_device"] * 8 >= one
    # the FSDP gathers at least, on every cell
    assert roof["collective_bytes_per_device"] > 0
    assert roof["collective_seconds"] > 0
    assert roof["memory_stats"]["temp_bytes"] > 0
    assert roof["memory_stats"]["argument_bytes"] == jax_argument_bytes[arch]
    assert not torch.distributed.is_initialized()


def _meshed(arch: str, shape_name: str, B: int, T: int) -> dict:
    return dryrun.run_cell(arch, shape_name, "multi", device="cpu",
                           reduced=True, mesh_shape=(2, 2, 2), verbose=False,
                           shape=_shape(shape_name, B, T))


@pytest.mark.parametrize("arch,shape_name,B,T", DENSE[1:],
                         ids=[c[1] for c in DENSE[1:]])
def test_dense_cell_flops_per_device_times_chips_is_one_device(
        arch, shape_name, B, T):
    """stablelm's prefill and decode (its train cell is in the test
    above): every product is split over the 8 ranks, none replicated."""
    roof = _meshed(arch, shape_name, B, T)["roofline"]
    assert roof["flops_per_device"] * 8 == _one_device_flops(
        arch, shape_name, B, T)
    assert roof["collective_bytes_per_device"] > 0


def test_cli_records_skips_and_failures(tmp_path, monkeypatch, capsys):
    """The JSON records a skipped cell, a FAILED cell makes the run exit
    1, and ``--append`` keeps what was done."""
    out = tmp_path / "r.json"
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--out", str(out), "--device", "cpu"])
    rows = json.loads(out.read_text())
    assert [(r["status"], r["mesh"]) for r in rows] == [
        ("skipped", "single"), ("skipped", "multi")]

    def boom(*args, **kwargs):
        raise RuntimeError("no strategy")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "stablelm-12b", "--shape", "train_4k",
                     "--mesh", "single", "--out", str(out), "--append",
                     "--device", "cpu"])
    assert e.value.code == 1
    rows = json.loads(out.read_text())
    assert [r["status"] for r in rows] == ["skipped", "skipped", "FAILED"]
    assert "no strategy" in rows[-1]["error"]
    assert "1 FAILED" in capsys.readouterr().out
