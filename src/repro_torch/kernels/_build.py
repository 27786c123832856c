"""Build and load the port's CUDA sources (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into ``src/repro_torch/_build/`` (listed in
``.gitignore``) at first use, keyed by the source's hash, and loaded
with :mod:`ctypes`.  Nothing is compiled when a module is imported.

The wrappers of every kernel family share the launch helpers here: the
plan cache (``PLANS``, keyed by :func:`signature`, filled by
:func:`remember`), :func:`launch_on`, and for the ``cp.async`` rings of
the scans :func:`copy_width` and :func:`pointer_width`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Every source of csrc/, by name; chip_smoke.py builds them all at once.
SOURCES = ("queue_front", "attention", "rwkv6_scan", "mamba_scan",
           "graph_cond")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> compiler log (ptxas register / shared-memory report)
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}

# Call signature (each operand's shape, strides, dtype and device, and the
# host arguments that the checks read) -> its launch arguments, built once
# by a wrapper's full checks; a call whose signature was checked before
# skips them.  The keys start with the kernel's name.
PLANS: dict = {}
MAX_PLANS = 1024


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(pathlib.Path(home) / "bin" / "nvcc")


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source
    exists; returns the shared library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    BUILD_LOG[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{BUILD_LOG[name]}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def signature(*tensors) -> tuple:
    """What the checks of a call read: each operand's shape, strides,
    dtype and device."""
    return tuple((t.shape, t.stride(), t.dtype, t.device) for t in tensors)


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when autograd would record a call of ``kernel``: it has no
    backward (nor has the JAX package's Pallas kernel, so ``jax.grad``
    fails there too), and its output would carry no gradient, so a loss
    through it would train on zeros.  Checked on both routes, before any
    launch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward (neither has the JAX package's "
            "Pallas kernel): autograd cannot differentiate through it; "
            "train with attn_impl='blockwise' or 'reference'")


def remember(key, plan):
    if len(PLANS) >= MAX_PLANS:
        PLANS.clear()
    PLANS[key] = plan
    return plan


def copy_width(itemsize: int, strides, row_bytes) -> int:
    """The widest ``cp.async`` copy (16, 8 or 4 bytes) that every stride
    (in elements) and every row length (in bytes) is a multiple of; else
    ``itemsize`` (2 for bf16: the kernel copies such rows with plain
    loads).  The pointers' own alignment is taken per call
    (:func:`pointer_width`)."""
    for width in (16, 8, 4):
        if all(s * itemsize % width == 0 for s in strides) and \
                all(b % width == 0 for b in row_bytes):
            return width
    return itemsize


def pointer_width(width: int, *ptrs) -> int:
    """``width`` narrowed to what every pointer is aligned to (16, 8, 4
    or 2 bytes)."""
    for p in ptrs:
        width = min(width, p & -p)
    return width


def launch_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current and its current
    stream; ``torch.cuda.device`` is entered only when ``device`` is not
    current already.  The stream is read raw, as PyTorch's generated
    kernels read it: ``torch.cuda.current_stream()`` builds a Stream
    object on every call."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
