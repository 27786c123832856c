"""Gradient compression for the data-parallel all-reduce (PyTorch port of
:mod:`repro.training.compression`).

int8 uniform quantization with per-leaf scales and an error-feedback
buffer (the residual of each quantization is added to the next step's
gradient).  The element-wise functions are JAX's bit for bit on the same
f32 input (``torch.round`` is half-to-even, as ``jnp.round``).

:func:`compressed_psum_gradients` is the all-reduce itself over a
``torch.distributed`` process group, the counterpart of JAX's
``shard_map`` + ``psum`` version: a MAX all-reduce of each leaf's scale
gives every rank one scale, the leaf is requantized against it, the int8
codes are summed as int32 (exact below 2^23 ranks) and the sum is
dequantized and divided by the group's size.
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map


def quantize_int8(x):
    """x fp -> (int8 q, f32 scale); symmetric per-tensor scaling."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_residual(x):
    """(quantized-representable part, residual error) of x.

    The residual is ``x - q * s`` rounded once, as XLA's fused
    multiply-add gives it in the jitted step: the product of an int8 code
    and an f32 scale is exact in f64 and so is its difference with x
    (the two are within half a scale of each other)."""
    q, s = quantize_int8(x)
    deq = dequantize_int8(q, s)
    res = (x.double() - q.double() * s.double()).float()
    return deq, res


def error_feedback_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def apply_error_feedback(grads, ef_state):
    """g' = g + e_{t-1} (in f32)."""
    return tree_map(lambda g, e: g.float() + e, grads, ef_state)


def compressed_psum_gradients(grads, group=None):
    """All-reduce-mean ``grads`` (a tree of this rank's gradients) over
    ``group`` (the default process group when ``None``) with an int8
    payload; every rank returns the same f32 tree."""
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def reduce_leaf(g):
        _, s = quantize_int8(g)
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)  # common scale
        # re-quantize against the common scale for exactness
        q = torch.clamp(torch.round(g.float() / s), -127, 127).to(torch.int8)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.float() * s / n

    return tree_map(reduce_leaf, grads)
