"""Mesh construction for the production topology (PyTorch port of
:mod:`repro.launch.mesh`).

Single pod: (16, 16) = 256 ranks, axes ("data", "model") — TP within
the "model" axis, DP/FSDP over "data".

Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") —
the "pod" axis carries ONLY data parallelism (the gradient all-reduce
across pods); parameters, FSDP shards and TP stay within a pod.

The sharded device engine's ``placement="devices"``: a 1-D ``"shards"``
mesh, one rank a shard queue (:func:`make_shard_mesh`,
:func:`shard_device`).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
default process group, which the caller initializes: the ``"fake"``
backend of 256 or 512 ranks for the dry run
(:mod:`repro_torch.launch.dryrun`, no hardware), NCCL on the card, gloo
in the CPU tests.  Everything here is a FUNCTION: importing this module
touches no process group.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.models.shards import dp_axes


def _device_type(device) -> str:
    """The mesh's device type: ``device``'s, or the CUDA card's."""
    if device is None:
        return "cuda"
    return torch.device(device).type


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """The default process group, for the block, on torch's ``"fake"``
    backend of ``world_size`` ranks (this process is ``rank``): a mesh
    of any size without hardware, whose collectives move nothing.
    Raises if a default group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; the "
                           "fake group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The (16, 16) pod or the (2, 16, 16) multi-pod mesh over the
    default process group, which must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, *, device=None) -> DeviceMesh:
    """A ("data", "model") mesh over the ranks that exist (one rank of
    a world of one on a single card)."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model_axis}")
    return init_device_mesh(_device_type(device), (n // model_axis,
                                                   model_axis),
                            mesh_dim_names=("data", "model"))


def make_shard_mesh(shards: int, *, device=None) -> DeviceMesh:
    """The 1-D ``"shards"`` mesh of the sharded device engine's
    ``placement="devices"`` path over the default process group: one
    rank a shard queue (JAX's ``make_shard_mesh``, one device a shard).

    The caller's process group picks the backend (NCCL on several cards,
    gloo on the CPU or for several ranks on one card); the engine never
    does.  Raises with the hardware-free recipe when no group of exactly
    ``shards`` ranks exists: a process cannot grow its group from here,
    as a JAX process cannot grow its device count after the first
    device query."""
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != shards:
        found = (f"has {have} rank(s)" if have
                 else "is not initialized")
        raise ValueError(
            f"placement='devices' with shards={shards} runs one process a "
            f"shard over the default process group, which {found}. For a "
            f"hardware-free run, start {shards} processes on the CPU, each "
            "calling torch.distributed.init_process_group('gloo', "
            "init_method='tcp://localhost:<port>', rank=r, "
            f"world_size={shards}) and building with device='cpu'; on "
            f"{shards} cards, launch with torchrun --nproc-per-node="
            f"{shards} (NCCL); or use placement='serial'.")
    return init_device_mesh(_device_type(device), (shards,),
                            mesh_dim_names=("shards",))


def shard_device(device=None) -> torch.device:
    """A rank's device on the ``"shards"`` mesh: ``device`` when it
    names one (``"cpu"``, ``"cuda:1"``), else the card
    ``cuda:(LOCAL_RANK % device_count)`` (the rank when ``LOCAL_RANK``
    is unset), so ranks beyond the host's cards share them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "engine on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh[a].size()
    return n


def tp_size(mesh) -> int:
    return mesh["model"].size() if "model" in mesh.mesh_dim_names else 1
