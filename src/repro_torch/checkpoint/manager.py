"""Checkpointing: atomic, async, integrity-checked (PyTorch port).

The on-disk format is :mod:`repro.checkpoint.manager`'s, so a checkpoint
written by either package restores in the other:

* one ``step_%010d/`` directory per checkpoint, written under a
  ``.tmp`` name and renamed into place, so a crash mid-save never
  leaves a partial "latest" checkpoint;
* one ``.npy`` file per leaf, named by the leaf's path in the tree the
  way JAX spells it (dict keys in sorted order joined by dots,
  NamedTuple fields by name, sequence items by index: ``queue.f_times``,
  ``state.counts``, ``stats.batches``);
* ``manifest.json`` with each leaf's shape, logical dtype and a 16-hex
  sha256 over every byte and the shape.

A leaf is a tensor (any device), a numpy array or scalar, or a Python
int or float.  Python ints are stored as int32 and floats as float32,
as JAX's carry holds them: the engine's host counters (``batches``,
``events``) are such ints.  bf16 tensors are stored as their raw uint16
bits with logical dtype ``bfloat16``.

A ``DTensor`` leaf (the sharded engine's placed queue) is saved whole:
every rank of its mesh calls ``save``/``save_async`` with the same tree,
each placed leaf is gathered (a collective), rank 0 writes, and every
rank waits for the write at a barrier (in ``save``, or in the next
``wait``), so no rank restores before the files exist.  A restore into
such a template gives whole plain tensors, which the engine's
``place_queue`` re-places.

``save_async`` takes the host copy on the caller's thread (for a CUDA
tensor that waits for the device), so the snapshot is consistent even
when the caller then updates the tensors in place; only the file write
runs on the writer thread.  A writer failure is re-raised from
``wait()`` or the next ``save_async``.  ``keep_last`` newest
checkpoints are retained.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import key_leaves, tree_unflatten


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    out = []
    for name, leaf in key_leaves(tree):
        fname = (
            name.replace("']['", ".").replace("['", "").replace("']", "")
            .replace("[", ".").replace("]", "").replace("/", "_")
        )
        out.append((fname, leaf))
    return out


def _placed(leaf) -> bool:
    return hasattr(leaf, "device_mesh")  # a DTensor


def _whole(leaf) -> torch.Tensor:
    """A placed leaf's whole tensor on this rank (a collective)."""
    from torch.distributed.tensor import Shard

    if tuple(leaf.placements) == (Shard(0),):
        from repro_torch.core.queue import all_gather_rows

        return all_gather_rows(leaf.to_local(),
                               leaf.device_mesh.get_group())
    return leaf.full_tensor()


def _to_host(leaf):
    """A host numpy copy of one leaf, and its logical dtype name."""
    if _placed(leaf):
        leaf = _whole(leaf)
    if torch.is_tensor(leaf):
        # A copy even for a CPU tensor: the caller may update it in place
        # while the writer thread runs.
        host = leaf.detach().to("cpu", copy=True)
        if leaf.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = host.numpy()
    elif isinstance(leaf, bool):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        arr = np.asarray(leaf, np.float32)
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _checksum(arr: np.ndarray) -> str:
    # Full-content digest, chunked so large leaves never materialize a
    # second copy.
    h = hashlib.sha256()
    view = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    chunk = 1 << 24
    for start in range(0, view.size, chunk):
        h.update(view[start:start + chunk].tobytes())
    h.update(str(arr.shape).encode())
    return h.hexdigest()[:16]


def _bf16_tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        # The process group of a collective save not yet waited for.
        self._group = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        host, group = self._host_leaves(tree)
        path = os.path.join(self.directory, f"step_{step:010d}")
        if group is None or dist.get_rank(group) == 0:
            path = self._write(step, host)
        if group is not None:
            dist.barrier(group)
        return path

    def save_async(self, step: int, tree) -> None:
        self.wait()  # raises here if the previous async write failed
        # The host copy happens NOW (a consistent snapshot); the disk
        # writes happen on the thread.
        host, group = self._host_leaves(tree)
        self._group = group
        if group is None or dist.get_rank(group) == 0:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host), daemon=True)
            self._thread.start()

    @staticmethod
    def _host_leaves(tree) -> tuple:
        """Every leaf's host copy, and the process group of the tree's
        placed leaves (``None`` when it has none)."""
        leaves = _leaf_paths(tree)
        group = next((leaf.device_mesh.get_group() for _, leaf in leaves
                      if _placed(leaf)), None)
        return [(fname, *_to_host(leaf)) for fname, leaf in leaves], group

    def _write_guarded(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
            self._exc = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        group, self._group = self._group, None
        if group is not None:
            dist.barrier(group)
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _write(self, step: int, host) -> str:
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for fname, arr, logical_dtype in host:
            np.save(os.path.join(tmp, fname + ".npy"), arr)
            manifest["leaves"][fname] = {
                "shape": list(arr.shape),
                "dtype": logical_dtype,
                "checksum": _checksum(arr),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _open(self, step: Optional[int]):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return step, path, manifest

    @staticmethod
    def _load(path, manifest, name, step, verify):
        arr = np.load(os.path.join(path, name + ".npy"))
        meta = manifest["leaves"][name]
        if verify and _checksum(arr) != meta["checksum"]:
            raise IOError(f"checksum mismatch for {name} @ step {step}")
        return arr, meta

    _MISSING = object()

    def restore_leaf(self, name: str, step: Optional[int] = None, *,
                     verify: bool = True, default=_MISSING):
        """Load ONE leaf by manifest name, its shape taken from the file:
        for variable-length sidecar leaves (the spill pool, the arrival
        cursor).  ``default`` (when given) is returned for a leaf absent
        from the manifest.  A numpy array, or a bf16 tensor."""
        step, path, manifest = self._open(step)
        if name not in manifest["leaves"]:
            if default is not CheckpointManager._MISSING:
                return default
            raise KeyError(
                f"leaf {name!r} not in checkpoint step {step}; "
                f"available: {sorted(manifest['leaves'])}")
        arr, meta = self._load(path, manifest, name, step, verify)
        if meta["dtype"] == "bfloat16":
            return _bf16_tensor(arr)
        return arr

    def restore(self, template, step: Optional[int] = None, *,
                verify: bool = True):
        """Restore into the structure of ``template``; returns ``(tree,
        step)``.  Each leaf takes its template leaf's kind: a tensor of
        the template's dtype on the template's device, a numpy array of
        its dtype, or a Python int / float."""
        step, path, manifest = self._open(step)
        leaves = []
        for name, tmpl in _leaf_paths(template):
            arr, meta = self._load(path, manifest, name, step, verify)
            shape = (tuple(tmpl.shape) if hasattr(tmpl, "shape")
                     else ())
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"{name}: checkpoint shape {arr.shape} != "
                    f"template {shape}")
            if torch.is_tensor(tmpl):
                t = (_bf16_tensor(arr) if meta["dtype"] == "bfloat16"
                     else torch.from_numpy(np.array(arr)))
                leaves.append(t.to(tmpl.dtype).to(tmpl.device))
            elif isinstance(tmpl, bool):
                leaves.append(bool(arr))
            elif isinstance(tmpl, int):
                leaves.append(int(arr))
            elif isinstance(tmpl, float):
                leaves.append(float(arr))
            else:
                leaves.append(np.asarray(arr).astype(np.asarray(tmpl).dtype))
        return tree_unflatten(template, leaves), step
