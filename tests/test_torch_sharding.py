"""The port's mesh and sharding rules (``repro_torch.launch.mesh``,
``sharding``) against JAX's (``repro.launch.mesh``, ``sharding``).

Every leaf of every registered config at full size: parameters, the
train state (``m``, ``v``, ``ef`` and ``step``), the batches of every
applicable shape and the decode caches of ``decode_32k`` (B 128) and
``long_500k`` (B 1), on both production meshes.  The port's specs
must equal JAX's ``PartitionSpec``s entry for entry, and its DTensor
placements must equal the placements this file derives from JAX's
specs on its own.  JAX's side runs in a child process with 512 fake
host devices (``--xla_force_host_platform_device_count``), which
leaves this process's JAX state alone; the port's side builds its
avatars on fake tensors and its meshes over a fake process group.
Tolerance: exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import shape_applicable
from repro_torch.core.tree import key_leaves
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import (
    dp_axes,
    dp_size,
    fake_process_group,
    make_production_mesh,
    make_shard_mesh,
    tp_size,
)
from repro_torch.launch.specs import batch_avatars
from repro_torch.models import LM
from repro_torch.training.train_step import train_state

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
DECODE_SHAPES = ("decode_32k", "long_500k")


def _norm(spec, ndim: int) -> list:
    """A spec's entries as lists of axis names, padded to ``ndim``."""
    out = []
    for ax in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append([] if ax is None else
                   [ax] if isinstance(ax, str) else list(ax))
    return out


def _write_jax_specs(path: str) -> None:
    """JAX's specs of every leaf, keyed ``arch|mesh|group|keystr``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.configs import list_configs as jlist
    from repro.configs import shape_applicable as japplicable
    from repro.launch import sharding as jsh
    from repro.launch.mesh import make_production_mesh as jmesh
    from repro.launch.specs import _batch_specs
    from repro.models import LM as JLM
    from repro.training.train_step import init_train_state

    out = {}

    def put(prefix, tree, shardings):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        sh = jax.tree_util.tree_leaves(shardings)
        for (p, leaf), s in zip(flat, sh):
            out[f"{prefix}|{jax.tree_util.keystr(p)}"] = _norm(
                s.spec, leaf.ndim)

    for mesh_name in MESHES:
        mesh = jmesh(multi_pod=mesh_name == "multi")
        for arch in jlist():
            cfg = jget(arch)
            model = JLM(cfg)
            state = jax.eval_shape(lambda: init_train_state(
                model, jax.random.PRNGKey(0), compression=True))
            put(f"{arch}|{mesh_name}|state", state,
                jsh.state_shardings(mesh, state))
            put(f"{arch}|{mesh_name}|params", state["params"],
                jsh.param_shardings(mesh, state["params"]))
            for shape_name, shape in JSHAPES.items():
                if not japplicable(cfg, shape_name)[0]:
                    continue
                B, T = shape["global_batch"], shape["seq_len"]
                if shape["kind"] == "decode":
                    cache = jax.eval_shape(lambda: model.init_cache(B, T))
                    put(f"{arch}|{mesh_name}|cache/{shape_name}", cache,
                        jsh.cache_shardings(mesh, cache, batch=B))
                else:
                    batch = _batch_specs(cfg, B, T)
                    put(f"{arch}|{mesh_name}|batch/{shape_name}", batch,
                        jsh.batch_shardings(mesh, batch))
    del jnp
    with open(path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_specs") / "specs.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_sharding as t; t._write_jax_specs(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def _placements_from(spec: list, names) -> tuple:
    """Placements of a normalized JAX spec, one a mesh dim."""
    out = []
    for name in names:
        dims = [d for d, axes in enumerate(spec) if name in axes]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _port_groups(cfg, mesh):
    """``group -> (value tree, spec tree, placement tree)`` of the
    port, on fake-tensor avatars at full size."""
    out = {}
    with FakeTensorMode():
        model = LM(cfg, device="cpu")
        state = train_state(model.stacked_params(), compression=True)
        out["state"] = (state, tsh.state_specs(mesh, state),
                        tsh.state_placements(mesh, state))
        out["params"] = (state["params"],
                         tsh.param_specs(mesh, state["params"]),
                         tsh.param_placements(mesh, state["params"]))
        for shape_name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape_name)[0]:
                continue
            B, T = shape["global_batch"], shape["seq_len"]
            if shape["kind"] == "decode":
                cache = model.init_cache(B, T)
                out[f"cache/{shape_name}"] = (
                    cache, tsh.cache_specs(mesh, cache, batch=B),
                    tsh.cache_placements(mesh, cache, batch=B))
            else:
                batch = batch_avatars(cfg, B, T, torch.device("cpu"))
                out[f"batch/{shape_name}"] = (
                    batch, tsh.batch_specs(mesh, batch),
                    tsh.batch_placements(mesh, batch))
    return out


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", list_configs())
def test_placements_match_jax(arch, mesh_name, jax_specs):
    cfg = get_config(arch)
    world = 512 if mesh_name == "multi" else 256
    with fake_process_group(world):
        mesh = make_production_mesh(multi_pod=mesh_name == "multi",
                                    device="cpu")
        groups = _port_groups(cfg, mesh)
        names = mesh.mesh_dim_names
    want_groups = {key.split("|")[2] for key in jax_specs
                   if key.startswith(f"{arch}|{mesh_name}|")}
    assert want_groups == set(groups)
    checked = 0
    for group, (tree, specs, places) in groups.items():
        leaves = list(key_leaves(tree))
        spec_leaves = [s for _, s in key_leaves(specs)]
        place_leaves = _flat_placements(tree, places)
        assert len(spec_leaves) == len(leaves) == len(place_leaves)
        for (path, leaf), spec, placed in zip(leaves, spec_leaves,
                                              place_leaves):
            key = f"{arch}|{mesh_name}|{group}|{path}"
            assert key in jax_specs, key
            want = jax_specs[key]
            assert _norm(spec, leaf.ndim) == want, (key, spec, want)
            assert placed == _placements_from(want, names), (key, placed)
            checked += 1
    prefix = f"{arch}|{mesh_name}|"
    assert checked == sum(1 for k in jax_specs if k.startswith(prefix))


def _flat_placements(tree, places) -> list:
    """The placement tuples of ``places`` (the structure of ``tree``,
    whose leaves are tuples) in ``tree``'s leaf order."""
    out = []

    def walk(t, p):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], p[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(t, p):
                walk(a, b)
        elif t is not None:
            out.append(p)

    walk(tree, places)
    return out


def test_mesh_helpers_on_a_fake_group():
    """Axis names and sizes as JAX's; the sharded engine's 1-D
    ``"shards"`` mesh (ROADMAP D1) needs a group of as many ranks as
    shards, else names the process-group recipe."""
    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert dp_axes(mesh) == ("pod", "data")
        assert (dp_size(mesh), tp_size(mesh)) == (32, 16)
    with fake_process_group(256):
        mesh = make_production_mesh(device="cpu")
        assert dp_axes(mesh) == ("data",)
        assert (dp_size(mesh), tp_size(mesh)) == (16, 16)
    with fake_process_group(4):
        mesh = make_shard_mesh(4, device="cpu")
        assert mesh.mesh_dim_names == ("shards",)
        assert tuple(mesh.shape) == (4,)
        with pytest.raises(ValueError, match="has 4 rank"):
            make_shard_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="nproc-per-node=4"):
        make_shard_mesh(4)
    assert not torch.distributed.is_initialized()


def test_anchor_context_restores_and_is_identity_without_a_mesh():
    """The anchors act inside ``anchored`` alone; outside it, and on
    plain tensors, they return their argument."""
    x = torch.zeros(32, 16, 8)
    assert tsh.anchor_mesh() is None
    for fn in (tsh.shard_batch_dim, tsh.shard_seq_dim,
               tsh.gather_head_for_unembed):
        assert fn(x) is x
    with fake_process_group(4):
        from repro_torch.launch.mesh import make_host_mesh
        from torch.distributed.tensor import distribute_tensor

        mesh = make_host_mesh(2, device="cpu")
        with FakeTensorMode():
            d = distribute_tensor(torch.empty(32, 16, 8), mesh,
                                  [Replicate(), Replicate()])
            assert tsh.shard_batch_dim(d) is d       # no mesh registered
            with tsh.anchored(mesh):
                assert tsh.anchor_mesh() is mesh
                with tsh.anchored(None):
                    assert tsh.anchor_mesh() is None
                assert tsh.shard_batch_dim(d).placements == (
                    Shard(0), Replicate())
                assert tsh.shard_seq_dim(d).placements == (Shard(0),
                                                           Shard(1))
                assert tsh.gather_head_for_unembed(d).placements == (
                    Replicate(), Shard(0))
                assert tsh.shard_batch_dim(x) is x
            try:
                with tsh.anchored(mesh):
                    raise KeyError("leaves the block")
            except KeyError:
                pass
        assert tsh.anchor_mesh() is None
