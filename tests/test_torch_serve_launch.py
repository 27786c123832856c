"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the JAX package's: the same arguments, request generator and
printout, on the CPU at the reduced size, and the card by default."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve as tserve

ROOT = Path(__file__).resolve().parents[1]


def test_serve_launcher_reduced_on_cpu(capsys):
    assert tserve.main(["--arch", "stablelm-12b", "--reduced",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out
    assert "decode events: 43  fused batches: 7" in out


def test_serve_launcher_rwkv6_reduced_on_cpu(capsys):
    assert tserve.main(["--arch", "rwkv6-1.6b", "--reduced",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out
    assert "decode events: 43  fused batches: 7" in out
    assert "singles: 18  prefills: 6" in out


def test_serve_launcher_jamba_reduced_on_cpu(capsys):
    assert tserve.main(["--arch", "jamba-1.5-large-398b", "--reduced",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out
    assert "decode events: 43  fused batches: 7 (mean len 4.00)" in out
    assert "singles: 18  prefills: 6" in out


def test_serve_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "stablelm-12b", "--reduced"])


def test_serve_launcher_prints_what_the_jax_launcher_prints():
    """Same arguments, same request generator, same control-plane
    printout (the wall-clock line aside)."""
    def run(module, extra):
        proc = subprocess.run(
            [sys.executable, "-m", module, "--arch", "stablelm-12b",
             "--reduced", "--requests", "2", "--max-new", "4", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
                 "PATH": "/usr/bin:/bin"})
        assert proc.returncode == 0, proc.stderr
        return [line for line in proc.stdout.splitlines()
                if "s wall" not in line]

    assert run("repro_torch.launch.serve", ["--device", "cpu"]) == \
        run("repro.launch.serve", [])


def test_serve_launcher_rwkv6_prints_what_the_jax_launcher_prints():
    """The rwkv6 control plane of the launcher's defaults (6 requests of
    12 tokens), the wall-clock line aside."""
    def run(module, extra):
        proc = subprocess.run(
            [sys.executable, "-m", module, "--arch", "rwkv6-1.6b",
             "--reduced", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
                 "PATH": "/usr/bin:/bin"})
        assert proc.returncode == 0, proc.stderr
        return [line for line in proc.stdout.splitlines()
                if "s wall" not in line]

    assert run("repro_torch.launch.serve", ["--device", "cpu"]) == \
        run("repro.launch.serve", [])


def test_serve_launcher_jamba_prints_what_the_jax_launcher_prints():
    """The reduced jamba (one 8-layer block of gqa/mamba mixers and
    mlp/moe FFNs) under the launcher's defaults: the same control plane
    and finish times, the wall-clock line aside."""
    def run(module, extra):
        proc = subprocess.run(
            [sys.executable, "-m", module, "--arch", "jamba-1.5-large-398b",
             "--reduced", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
                 "PATH": "/usr/bin:/bin"})
        assert proc.returncode == 0, proc.stderr
        return [line for line in proc.stdout.splitlines()
                if "s wall" not in line]

    assert run("repro_torch.launch.serve", ["--device", "cpu"]) == \
        run("repro.launch.serve", [])
