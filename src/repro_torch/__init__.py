"""PyTorch/CUDA port of the compile-time event-batching simulator.

A second package beside the JAX reference ``repro``: the same module
layout and public surface (``repro_torch.api.SimProgram`` ->
``build(backend="device")`` -> ``run`` -> ``RunResult``), running on an
NVIDIA card with hand-written CUDA kernels for the queue's front tier,
plus the LM serving path (``repro_torch.launch.serve`` ->
``serving.engine.ServingEngine`` -> ``models.LM``) with hand-written
attention kernels.  It imports ``torch`` and numpy, never ``jax``,
``repro`` or ``ml_dtypes``.
"""
