"""Optimizer: AdamW with mixed-precision discipline + LR schedules
(PyTorch port of :mod:`repro.training.optim`).

Hand-written, as JAX's is (``torch.optim.AdamW`` keeps bf16 moments for
bf16 parameters): params may be bf16; the first and second moments and
the update are f32, rounded once to the parameter's dtype; weight decay
is decoupled.  The optimizer state mirrors the param tree.  The step
counter, the schedule and the bias corrections are f32 tensors
computed as JAX computes them.

Schedules: cosine (default) and WSD (warmup-stable-decay), the MiniCPM
schedule the minicpm-2b config calls for.

Weight decay follows JAX's ``_decay_mask``, which tests substrings of
the leaf's ``jax.tree_util.keystr`` path (the spelling of
:func:`repro_torch.core.tree.key_leaves`).  The token
``"mix"`` matches every ``['mixer']`` path, so no attention, Mamba or
RWKV time-mix weight is decayed: only the FFN, MoE and channel-mix
weights, the routers, ``embed`` and ``head`` are.  That is a property of
the reference, kept leaf for leaf.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.core.tree import key_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # constant | cosine | wsd
    warmup_steps: int = 100
    total_steps: int = 10_000
    stable_frac: float = 0.9      # WSD: fraction of steps at peak lr


def adamw_init(params) -> dict:
    """Zero f32 moments of the params' shapes and an int32 step 0 (on
    the first leaf's device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = next(iter(key_leaves(params)))[1].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        mult = torch.ones((), dtype=torch.float32, device=step.device)
    elif cfg.schedule == "cosine":
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        mult = 0.5 * (1.0 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # Warmup -> Stable (peak lr) -> exponential-ish Decay tail.
        stable_end = cfg.warmup_steps + cfg.stable_frac * (
            cfg.total_steps - cfg.warmup_steps)
        t = torch.clamp((step - stable_end)
                        / max(cfg.total_steps - stable_end, 1), 0.0, 1.0)
        mult = torch.where(step < stable_end, 1.0, torch.pow(0.5, t * 10.0))
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * mult


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, summed leaf
    by leaf in JAX's flatten order.  A ``DTensor`` leaf's sum is reduced
    over its shards before it joins the total."""
    total = 0
    for _, leaf in key_leaves(tree):
        part = torch.sum(torch.square(leaf.float()))
        if isinstance(part, DTensor):
            part = part.redistribute(part.device_mesh,
                                     [Replicate()] * part.device_mesh.ndim)
        total = total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    """-> (grads scaled to a global norm of at most ``max_norm``, in f32
    as JAX's promotion of ``g * scale`` gives, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


_NO_DECAY_TOKENS = ("norm", "scale", "bias", "decay_base", "bonus_u",
                    "dt_bias", "A_log", "mix")


def _decay_mask(path: str) -> bool:
    return not any(tok in path for tok in _NO_DECAY_TOKENS)


def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """Returns ``(new_params, new_opt_state, metrics)``; ``metrics``
    holds ``lr`` and ``grad_norm`` (0-d f32 tensors)."""
    step = opt_state["step"] + 1
    lr = schedule_lr(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    flat_p = list(key_leaves(params))
    flat_g = [g for _, g in key_leaves(grads)]
    flat_m = [m for _, m in key_leaves(opt_state["m"])]
    flat_v = [v for _, v in key_leaves(opt_state["v"])]

    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        gf = g.float()
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * torch.square(gf)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if _decay_mask(path):
            update = update + cfg.weight_decay * p.float()
        pnew = p.float() - lr * update
        new_p.append(pnew.to(p.dtype))
        new_m.append(m)
        new_v.append(v)

    params = tree_unflatten(params, new_p)
    opt_state = {
        "m": tree_unflatten(opt_state["m"], new_m),
        "v": tree_unflatten(opt_state["v"], new_v),
        "step": step,
    }
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
