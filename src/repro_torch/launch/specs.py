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

With ``mesh=None`` a cell is for one device, ``dp = 1``, so
``pick_microbatches(B, 1)`` gives JAX's count on its own host mesh.
Given a :class:`~torch.distributed.device_mesh.DeviceMesh` (the
production meshes of :mod:`repro_torch.launch.mesh`, over a fake
process group for the dry run), the avatars are ``DTensor``s placed by
the rules of :mod:`repro_torch.launch.sharding`, the cell carries their
placements as ``in_shardings`` and ``out_shardings`` (JAX's), and its
step runs inside :func:`~repro_torch.launch.sharding.anchored`, so the
model's activation anchors act.  A cell also carries ``out_specs`` (the
outputs' avatars, for the roofline's memory terms) and what
:func:`graph_cost.cell_cost` needs to rebuild it cut in depth and
length.  ``attn_impl="blockwise"`` (JAX's default here too) keeps the
kernels' wrappers, which fake tensors must never reach, off every path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.launch.mesh import dp_axes, dp_size
from repro_torch.launch.sharding import (
    P,
    anchored,
    batch_specs,
    cache_specs,
    distribute,
    module_param_specs,
    placements,
    placements_of,
    state_specs,
)
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
    mesh: Any = None
    # The placements of the arguments and outputs (JAX's in_shardings
    # and out_shardings; None for a one-device cell or an output left
    # to the step).
    in_shardings: Any = None
    out_shardings: Any = None


def batch_avatars(cfg: ArchConfig, B: int, T: int, device) -> dict:
    """The batch of a ``[B, T]`` cell: token ids or ``embeds``, labels,
    and the M-RoPE grid, as empty tensors on ``device``."""
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


def _anchored_step(fn, mesh):
    """``fn`` run inside ``anchored(mesh)``."""
    def step(*args, **kwargs):
        with anchored(mesh):
            return fn(*args, **kwargs)

    return step


def build_cell(cfg: ArchConfig, shape_name: str, mesh=None, *,
               shape: dict | None = None, device=None,
               num_microbatches: int | None = None,
               attn_impl: str = "blockwise", fsdp: bool = True,
               model_kwargs: dict | None = None) -> CellSpec:
    """The cell of ``cfg`` at ``SHAPES[shape_name]`` (or at ``shape``, a
    dict of the same keys), on ``mesh`` when given (``fsdp=False``: no
    parameter dim over ``data``).  ``device=None`` is the CUDA card,
    which must be present, as everywhere in the port; the avatars live
    on ``device`` (the mesh's device type) but hold no memory there."""
    shape = dict(SHAPES[shape_name] if shape is None else shape)
    kind = shape["kind"]
    B, T = shape["global_batch"], shape["seq_len"]
    dev = resolve_device(device)
    build_kw = dict(device=device, attn_impl=attn_impl, fsdp=fsdp,
                    model_kwargs=model_kwargs)
    mode = FakeTensorMode()
    common = dict(arch=cfg.name, shape=shape_name, kind=kind, cfg=cfg,
                  shape_spec=shape, build_kw=build_kw, fake_mode=mode,
                  mesh=mesh)
    dp = dp_size(mesh) if mesh is not None else 1

    def place(tree, specs):
        return distribute(tree, mesh, specs) if mesh is not None else tree

    def shardings(tree, specs):
        return (placements_of(mesh, tree, specs) if mesh is not None
                else None)

    with mode, anchored(mesh):
        model = LM(cfg, attn_impl=attn_impl, device=dev,
                   **(model_kwargs or {}))
        if kind == "train":
            nm = num_microbatches or pick_microbatches(B, dp)
            step = make_train_step(model, AdamWConfig(), num_microbatches=nm,
                                   remat=True)
            state = train_state(model.stacked_params())
            batch = batch_avatars(cfg, B, T, dev)
            ins = None
            if mesh is not None:
                sspec = state_specs(mesh, state, fsdp=fsdp)
                bspec = batch_specs(mesh, batch)
                ins = (shardings(state, sspec), shardings(batch, bspec))
                state, batch = place(state, sspec), place(batch, bspec)
                step = _anchored_step(step, mesh)
            metric = torch.empty((), dtype=torch.float32, device=dev)
            return CellSpec(
                fn=step, arg_specs=(state, batch),
                out_specs=(state, {"loss": metric, "lr": metric,
                                   "grad_norm": metric}),
                donate_argnums=(0,),
                static_info={"num_microbatches": nm, "tokens": B * T},
                in_shardings=ins,
                out_shardings=(ins[0], None) if ins is not None else None,
                **common)

        params = dict(model.named_parameters())
        pspec = (module_param_specs(mesh, model, fsdp=fsdp)
                 if mesh is not None else None)
        pin = shardings(params, pspec)
        params = place(params, pspec)
        cache = model.init_cache(B, T)      # placed by the anchors' mesh
        cspec = (cache_specs(mesh, cache, batch=B) if mesh is not None
                 else None)
        cout = shardings(cache, cspec)
        dp_ax = dp_axes(mesh) if mesh is not None else None
        if kind == "prefill":
            batch = batch_avatars(cfg, B, T, dev)
            batch.pop("labels")
            bspec = batch_specs(mesh, batch) if mesh is not None else None
            bin_ = shardings(batch, bspec)
            batch = place(batch, bspec)
            prefill = _as_step(model, "prefill")

            def prefill_step(params, batch):
                return prefill(params, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               positions=batch.get("positions"), max_len=T)

            logits = torch.empty((B, cfg.padded_vocab), dtype=torch.float32,
                                 device=dev)
            if mesh is not None:
                prefill_step = _anchored_step(prefill_step, mesh)
            return CellSpec(
                fn=prefill_step, arg_specs=(params, batch),
                out_specs=(logits, cache), donate_argnums=(),
                static_info={"tokens": B * T},
                in_shardings=(pin, bin_) if mesh is not None else None,
                out_shardings=((placements(mesh, P(dp_ax, "model")), cout)
                               if mesh is not None else None),
                **common)

        # decode: one new token against a seq_len cache (its lengths are
        # zeros here; the step's work does not depend on them)
        tokens = torch.empty((B, 1), dtype=torch.int32, device=dev)
        logits = torch.empty((B, 1, cfg.padded_vocab), dtype=torch.float32,
                             device=dev)
        step = _as_step(model, "decode_step")
        tin = tout = None
        if mesh is not None:
            rows = dp_ax if B >= dp else None
            tin = placements(mesh, P(rows, None))
            tout = placements(mesh, P(rows, None, "model"))
            tokens = distribute(tokens, mesh, P(rows, None))
            step = _anchored_step(step, mesh)
        return CellSpec(
            fn=step, arg_specs=(params, cache, tokens),
            out_specs=(logits, cache), donate_argnums=(1,),
            static_info={"tokens": B},
            in_shardings=(pin, cout, tin) if mesh is not None else None,
            out_shardings=(tout, cout) if mesh is not None else None,
            **common)
