"""Per-(arch × shape) lowering specs (PyTorch port of
:mod:`repro.launch.specs`).

``build_cell(cfg, shape_name)`` returns a :class:`CellSpec`: the step
function and its argument avatars, fake tensors of the step's shapes
and dtypes (``FakeTensorMode``: no allocation, no random draw), so that
a full-size cell, llama3-405b's or jamba-1.5-large's, builds in well
under a second on any host.  Call ``cell.fn(*cell.arg_specs)`` inside
``cell.fake_mode`` (:func:`repro_torch.launch.graph_cost.trace_cost`
does).

Shape kinds (configs/base.SHAPES):
* train_*   -> ``make_train_step`` (microbatched, remat, AdamW);
* prefill_* -> ``LM.prefill`` (full sequence -> last logits + a cache of
  ``max_len = T``);
* decode_*  -> ``LM.decode_step`` (ONE new token against a ``seq_len``
  cache).

The port's ``LM`` holds its weights, so the prefill and decode steps
take them as their first argument through
:func:`torch.func.functional_call` (the module's parameters by name):
like JAX's, each step is a function of its arguments.  The train step
takes the train state (the JAX-layout tree of
:func:`repro_torch.training.train_step.train_state`, built from the
avatar model's ``stacked_params``, not from ``init_train_state``, which
draws values).

Shardings are not built: JAX's cells carry ``in_shardings`` and
``out_shardings`` from its mesh and sharding rules, which need more
than one GPU (ROADMAP D3).  Every cell is for one device, ``dp = 1``,
so ``pick_microbatches(B, 1)`` gives JAX's count on its own host mesh.
In their place a cell carries ``out_specs`` (the outputs' avatars, for
the roofline's memory terms) and what :func:`graph_cost.cell_cost`
needs to rebuild it cut in depth.  ``attn_impl="blockwise"`` (JAX's
default here too) keeps the kernels' wrappers, which fake tensors must
never reach, off every path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import LM
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train_step import make_train_step, train_state


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str
    fn: Callable
    arg_specs: tuple
    out_specs: Any
    donate_argnums: tuple
    static_info: dict
    cfg: ArchConfig
    shape_spec: dict
    build_kw: dict
    fake_mode: FakeTensorMode


def _batch_specs(cfg: ArchConfig, B: int, T: int, device):
    specs = {}
    if cfg.input_mode == "embeds":
        specs["embeds"] = torch.empty((B, T, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    else:
        specs["tokens"] = torch.empty((B, T), dtype=torch.int32,
                                      device=device)
    specs["labels"] = torch.empty((B, T), dtype=torch.int32, device=device)
    if cfg.m_rope:
        specs["positions"] = torch.empty((3, B, T), dtype=torch.int32,
                                         device=device)
    return specs


def pick_microbatches(global_batch: int, dp: int, *,
                      target_per_device: int = 1, cap: int = 16) -> int:
    per_dev = max(1, global_batch // dp)
    return max(1, min(cap, per_dev // target_per_device))


class _Call(torch.nn.Module):
    """Holds the model, so that ``functional_call`` can swap its
    parameters for a step's ``params`` argument."""

    def __init__(self, model: LM, method: str):
        super().__init__()
        self.lm = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.lm, self.method)(*args, **kwargs)


def _as_step(model: LM, method: str):
    """``step(params, *args)``: ``model.<method>(*args)`` run on
    ``params`` (the module's parameters by name)."""
    call = _Call(model, method)

    def step(params, *args, **kwargs):
        named = {f"lm.{k}": v for k, v in params.items()}
        return torch.func.functional_call(call, named, args, kwargs)

    return step


def build_cell(cfg: ArchConfig, shape_name: str, *, shape: dict | None = None,
               device=None, num_microbatches: int | None = None,
               attn_impl: str = "blockwise",
               model_kwargs: dict | None = None) -> CellSpec:
    """The cell of ``cfg`` at ``SHAPES[shape_name]`` (or at ``shape``, a
    dict of the same keys).  ``device=None`` is the CUDA card, which
    must be present, as everywhere in the port; the avatars live on
    ``device`` but hold no memory there."""
    shape = dict(SHAPES[shape_name] if shape is None else shape)
    kind = shape["kind"]
    B, T = shape["global_batch"], shape["seq_len"]
    dev = resolve_device(device)
    build_kw = dict(device=device, attn_impl=attn_impl,
                    model_kwargs=model_kwargs)
    mode = FakeTensorMode()
    common = dict(arch=cfg.name, shape=shape_name, kind=kind, cfg=cfg,
                  shape_spec=shape, build_kw=build_kw, fake_mode=mode)
    with mode:
        model = LM(cfg, attn_impl=attn_impl, device=dev,
                   **(model_kwargs or {}))
        if kind == "train":
            nm = num_microbatches or pick_microbatches(B, 1)
            step = make_train_step(model, AdamWConfig(), num_microbatches=nm,
                                   remat=True)
            state = train_state(model.stacked_params())
            metric = torch.empty((), dtype=torch.float32, device=dev)
            return CellSpec(
                fn=step, arg_specs=(state, _batch_specs(cfg, B, T, dev)),
                out_specs=(state, {"loss": metric, "lr": metric,
                                   "grad_norm": metric}),
                donate_argnums=(0,),
                static_info={"num_microbatches": nm, "tokens": B * T},
                **common)

        params = dict(model.named_parameters())
        cache = model.init_cache(B, T)
        if kind == "prefill":
            bspec = _batch_specs(cfg, B, T, dev)
            bspec.pop("labels")
            prefill = _as_step(model, "prefill")

            def prefill_step(params, batch):
                return prefill(params, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               positions=batch.get("positions"), max_len=T)

            logits = torch.empty((B, cfg.padded_vocab), dtype=torch.float32,
                                 device=dev)
            return CellSpec(
                fn=prefill_step, arg_specs=(params, bspec),
                out_specs=(logits, cache), donate_argnums=(),
                static_info={"tokens": B * T}, **common)

        # decode: one new token against a seq_len cache (its lengths are
        # zeros here; the step's work does not depend on them)
        tokens = torch.empty((B, 1), dtype=torch.int32, device=dev)
        logits = torch.empty((B, 1, cfg.padded_vocab), dtype=torch.float32,
                             device=dev)
        return CellSpec(
            fn=_as_step(model, "decode_step"),
            arg_specs=(params, cache, tokens), out_specs=(logits, cache),
            donate_argnums=(1,), static_info={"tokens": B}, **common)
