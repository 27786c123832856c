"""The training step: loss -> grad -> AdamW, with microbatching + remat
(PyTorch port of :mod:`repro.training.train_step`).

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``, a function of its arguments as JAX's is: the state it is
given is not modified.  The state is a plain tree with the JAX
package's leaf names and shapes, ``{"params", "opt", ["ef"]}``:
``params`` in the JAX ``LM.init`` layout (each stage's layers stacked on
a leading ``[repeat]`` axis), ``opt`` AdamW's ``m``, ``v`` and ``step``,
and ``ef`` the error-feedback buffer when gradient compression is on.
So global-norm order and the decay mask follow JAX's tree, and the
port's :class:`~repro_torch.checkpoint.manager.CheckpointManager`
(JAX's format) restores a train state written by either package.

A step binds per-layer views of the stacked leaves into the model
(:meth:`repro_torch.models.model.LM.bind`) and takes
``torch.autograd.grad`` of :meth:`~repro_torch.models.model.LM.loss`
against the stacked leaves.  Gradient accumulation over microbatches is
a Python loop with f32 accumulators (JAX's ``lax.scan``), so activation
memory is bounded by one microbatch; the optimizer applies once per
global step.  Remat (recompute each pattern unit in the backward) is on
by default.
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import (
    key_leaves,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.models.model import LM
from repro_torch.training.compression import (
    apply_error_feedback,
    compress_residual,
    error_feedback_init,
)
from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update


def train_state(params, *, compression: bool = False) -> dict:
    """The train state of ``params`` (a JAX-layout tree): zero moments,
    step 0, and a zero error-feedback buffer with ``compression``."""
    state = {"params": params, "opt": adamw_init(params)}
    if compression:
        state["ef"] = error_feedback_init(params)
    return state


def init_train_state(model: LM, seed: int, *, compression: bool = False):
    """The weights ``LM.init(seed)`` draws for ``model``'s config, as a
    train state on ``model``'s device.  They are drawn into a scratch
    module, so ``model``'s own weights (a served model's) stay as they
    are, as JAX's pure ``init`` leaves its model."""
    scratch = LM(model.cfg, device=model.device).init(seed)
    return train_state(scratch.stacked_params(), compression=compression)


def _split_microbatches(batch: dict, num_micro: int) -> dict:
    """Split the global batch into ``num_micro`` microbatches, STRIDED:
    element ``(m, k)`` is global row ``m + num_micro * k``, as JAX's
    split (which keeps every microbatch across every data shard).  Each
    leaf gains a leading ``[num_micro]`` axis; M-RoPE ``positions``
    ``[3, B, T]`` split along dim 1."""
    def split(x, axis=0):
        b = x.shape[axis]
        if b % num_micro:
            raise ValueError(f"batch {b} not divisible by {num_micro}")
        per = b // num_micro
        new = x.shape[:axis] + (per, num_micro) + x.shape[axis + 1:]
        return torch.movedim(x.reshape(new), axis + 1, 0)

    return {name: split(x, axis=1 if name == "positions" and x.ndim == 3
                        else 0)
            for name, x in batch.items()}


def make_grad_fn(model: LM, *, num_microbatches: int = 1,
                 remat: bool = True):
    """Returns ``grad_fn(params, batch) -> (loss, grads)``: the mean loss
    over the strided microbatches and its gradient against each leaf of
    ``params`` (a JAX-layout tree), accumulated in f32 with microbatches
    (in the leaves' dtypes with one), as the JAX step computes them."""

    def micro_grads(params, micro):
        names, leaves = zip(*((name, t.detach().requires_grad_())
                              for name, t in key_leaves(params)))
        loss = model.loss(micro, params=tree_unflatten(params, leaves),
                          remat=remat)
        # Only the embedding table may go unread, and only when the batch
        # holds ``embeds``; it then takes a zero gradient, as under
        # jax.grad.  Any other unread leaf is a fault and raises.
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        unused = [n for n, g in zip(names, grads) if g is None]
        if unused not in ([], ["['embed']"] if "embeds" in micro else []):
            raise RuntimeError(f"the loss does not read {unused}")
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    def grad_fn(params, batch):
        if num_microbatches == 1:
            return micro_grads(params, batch)
        micros = _split_microbatches(batch, num_microbatches)
        loss = torch.zeros((), dtype=torch.float32,
                           device=micros["labels"].device)
        grads = tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)
        for m in range(num_microbatches):
            micro_loss, one = micro_grads(
                params, {k: v[m] for k, v in micros.items()})
            loss = loss + micro_loss
            grads = tree_map(lambda a, g: a.add_(g.float()), grads, one)
            del one
        inv = 1.0 / num_microbatches
        return loss * inv, tree_map(lambda g: g.mul_(inv), grads)

    return grad_fn


def make_train_step(model: LM, opt_cfg: AdamWConfig, *,
                    num_microbatches: int = 1, remat: bool = True):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss``, ``lr`` and ``grad_norm`` are 0-d f32 tensors."""
    grad_fn = make_grad_fn(model, num_microbatches=num_microbatches,
                           remat=remat)

    def train_step(state, batch):
        params = state["params"]
        loss, grads = grad_fn(params, batch)
        if "ef" in state:
            grads = apply_error_feedback(grads, state["ef"])
            pairs = [compress_residual(g) for g in tree_leaves(grads)]
            new_ef = tree_unflatten(grads, [res for _, res in pairs])
            grads = tree_unflatten(grads, [deq for deq, _ in pairs])
        params, opt, metrics = adamw_update(opt_cfg, params, grads,
                                            state["opt"])
        new_state = {"params": params, "opt": opt}
        if "ef" in state:
            new_state["ef"] = new_ef
        metrics["loss"] = loss
        return new_state, metrics

    return train_step
