"""LM: config-driven decoder (PyTorch port of :mod:`repro.models.model`).

An ``nn.Module`` for stacks of ``gqa``, ``mla``, ``mamba`` and ``rwkv``
mixers with ``mlp``, ``moe`` and ``rwkv_cm`` FFNs: every registered
architecture of the JAX package — the dense GQA ones (stablelm-12b,
llama3-405b, phi4-mini, minicpm-2b), granite-moe (``(gqa, moe)``),
deepseek-v2-lite (``(mla, mlp)`` then ``(mla, moe)``), rwkv6-1.6b
(``(rwkv, rwkv_cm)``), the jamba hybrid (``(gqa, mlp)``, ``(mamba,
moe)``, ...), qwen2-vl (GQA with M-RoPE) and hubert-xlarge (a
bidirectional encoder).  Entry points, as in the JAX package:

* ``forward``      — full-sequence logits and the summed MoE aux loss;
* ``loss``         — the training loss, ``ce + MOE_AUX_WEIGHT * aux``;
* ``prefill``      — full sequence + the decode cache;
* ``decode_step``  — one token against the cache.

``forward``, ``loss`` and ``prefill`` take token ids or ``embeds``
``[B, T, d_model]`` (the audio and VLM frontends' frame or patch
embeddings, cast to the embedding's dtype: bf16, JAX's
``DEFAULT_DTYPE``, unless the model or train state was cast), and
``positions``: ``[B, T]``, or with M-RoPE the ``[3, B, T]`` (temporal,
height, width) grid; by default ``0 .. T-1`` in every stream.
``decode_step`` takes text tokens, at the position ``lengths``.

``forward``, ``prefill`` and ``decode_step`` build no graph, and the
module's own parameters take no gradient.  ``loss`` runs with grad
enabled on the leaves of a train state's param tree, which keeps the
JAX layout (each stage's layers stacked ``[repeat, ...]``;
:meth:`LM.stacked_params`, :meth:`LM.bind`); ``remat`` recomputes each
pattern unit in the backward (``torch.utils.checkpoint``).  The
kernels have no backward: under ``attn_impl="pallas"`` a loss against
trainable leaves raises, as ``jax.grad`` fails through the Pallas
kernels.

The JAX ``lax.scan`` over stacked layer params becomes a Python loop
over ``self.layers``.  The decode cache keeps the JAX layout: a dict of
stacked ``[L, B, ...]`` leaves per stage plus ``lengths`` — K/V
``[L, B, S, KV, D]`` for GQA; the latents ``ckv`` ``[L, B, S, R]`` and
the rope keys ``kr`` ``[L, B, S, dr]`` for MLA; the SSM state ``h`` ``[L, B, I, N]`` f32
and the conv tail ``conv`` ``[L, B, d_conv - 1, I]`` for Mamba;
``x_att``/``x_ffn`` ``[L, B, 1, D]`` and the WKV state ``S``
``[L, B, H, K, K]`` f32 for RWKV.  ``decode_step`` writes each layer's
new entries into it in place.  ``attn_impl`` selects the kernels: under
``"pallas"`` attention runs ``flash_attention`` (full sequence: GQA, and
MLA at qk head dim ``dn + dr``, which JAX's ``mla_apply`` runs
``blockwise``) and ``decode_attention`` (GQA decode; MLA's absorbed
decode is plain torch in both packages), and the mamba and rwkv time-mixes of
``forward`` and ``prefill`` run the ``mamba_scan`` and ``rwkv6_scan``
kernels, which the JAX LM never reaches (its ``ssm.py`` runs
``lax.associative_scan`` and ``lax.scan``).  MoE FFNs dispatch with
capacity in ``forward``/``prefill`` and run dropless in ``decode_step``,
as JAX's do.

On a device mesh (:mod:`repro_torch.launch.mesh`) the weights, caches
and inputs are ``DTensor``s placed by :mod:`repro_torch.launch.sharding`
and the calls run inside its ``anchored(mesh)``: the activations take
JAX's anchors (the batch over the DP axes after the embedding, the
unembedding table over ``model``, and with ``seq_parallel`` the
residual's sequence dim over ``model`` after every layer), projections
run tensor-parallel on each rank's shards, and the attention cores,
scans, expert FFNs and the embedding lookup run on each rank's shards,
so the kernels' wrappers see plain tensors.  With no mesh
``seq_parallel`` is the identity, as JAX's constraint is on one device.

Parameters are created on the model's device without values; ``init``
fills them from a seeded ``torch.Generator`` layer by layer, so peak
memory stays at the weights plus one f32 temporary (one expert's
matrix for MoE stacks).  The weights differ from the JAX package's for
the same seed (another generator);
:func:`params_from_jax` carries the JAX weights across instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core.engine import resolve_device
from repro_torch.models import kvcache, shards
from repro_torch.models.attention import (
    gqa_apply,
    gqa_decode_apply,
    gqa_init,
    gqa_weight_shapes,
    mla_apply,
    mla_decode_apply,
    mla_init,
    mla_weight_shapes,
)
from repro_torch.models.layers import (
    DEFAULT_DTYPE,
    cross_entropy_loss,
    dense_init,
    embed_apply,
    embed_init,
    make_norm,
    mlp_apply,
    mlp_weight_shapes,
    unembed_apply,
)
from repro_torch.models.moe import (
    moe_apply,
    moe_apply_dense,
    moe_init,
    moe_weight_shapes,
)
from repro_torch.models.ssm import (
    mamba_apply,
    mamba_decode_step,
    mamba_init,
    mamba_weight_shapes,
    rwkv6_attn,
    rwkv6_attn_decode,
    rwkv6_channel_mix,
    rwkv6_channel_mix_init,
    rwkv6_channel_mix_weight_shapes,
    rwkv6_init,
    rwkv6_weight_shapes,
)

ATTN_IMPLS = ("blockwise", "reference", "pallas")
MOE_AUX_WEIGHT = 0.01
MIXERS = ("gqa", "mla", "mamba", "rwkv")
FFNS = ("mlp", "moe", "rwkv_cm")
# Cache leaves with a sequence axis (GQA's K/V, MLA's latents), which
# prefill pads into ``max_len`` rows; the others are recurrent states.
SEQ_CACHES = ("k", "v", "ckv", "kr")


def _params(shapes: dict, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                           requires_grad=False)
        for name, shape in shapes.items()})


def _norm_params(norm_params, dim, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(t, requires_grad=False)
        for name, t in norm_params(dim, device).items()})


class ParamTree(nn.Module):
    """Nested parameters from a ``{name: (shape, dtype) | {...}}`` spec,
    read as the JAX pytree is: ``tree["mix"]["r"]``.  State-dict keys
    join the path with dots (``mixer.mix.r``)."""

    def __init__(self, shapes: dict, device):
        super().__init__()
        for name, spec in shapes.items():
            if isinstance(spec, dict):
                self.add_module(name, ParamTree(spec, device))
            else:
                shape, dtype = spec
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _mla_dims(cfg: ArchConfig) -> dict:
    """The MLA spec's head and rank keywords of the ``mla_*`` functions
    (``mla_weight_shapes``/``mla_init`` also take ``d_model``)."""
    m = cfg.mla
    return dict(num_heads=cfg.num_heads, kv_lora_rank=m.kv_lora_rank,
                qk_nope_head_dim=m.qk_nope_head_dim,
                qk_rope_head_dim=m.qk_rope_head_dim,
                v_head_dim=m.v_head_dim)


def _moe_kw(cfg: ArchConfig) -> dict:
    """The MoE spec's keywords of ``moe_weight_shapes``/``moe_init``."""
    mo = cfg.moe
    return dict(d_model=cfg.d_model, d_ff_expert=mo.d_ff_expert,
                num_experts=mo.num_experts, num_shared=mo.num_shared,
                activation=cfg.activation)


class Block(nn.Module):
    """One layer: its two norms, the mixer and the FFN its
    :class:`LayerSpec` names."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, norm_params,
                 device):
        super().__init__()
        self.spec = spec
        self.mixer_norm = _norm_params(norm_params, cfg.d_model, device)
        self.ffn_norm = _norm_params(norm_params, cfg.d_model, device)
        if spec.mixer == "gqa":
            self.mixer = _params(gqa_weight_shapes(
                d_model=cfg.d_model, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim), DEFAULT_DTYPE, device)
        elif spec.mixer == "mla":
            self.mixer = ParamTree(mla_weight_shapes(
                d_model=cfg.d_model, **_mla_dims(cfg)), device)
        elif spec.mixer == "mamba":
            mm = cfg.mamba
            self.mixer = ParamTree(mamba_weight_shapes(
                d_model=cfg.d_model, d_state=mm.d_state, d_conv=mm.d_conv,
                expand=mm.expand), device)
        else:
            self.mixer = ParamTree(rwkv6_weight_shapes(cfg.d_model), device)
        if spec.ffn == "mlp":
            self.ffn = _params(mlp_weight_shapes(cfg.d_model, cfg.d_ff,
                                                 cfg.activation),
                               DEFAULT_DTYPE, device)
        elif spec.ffn == "moe":
            self.ffn = ParamTree(moe_weight_shapes(**_moe_kw(cfg)), device)
        else:
            self.ffn = ParamTree(rwkv6_channel_mix_weight_shapes(
                cfg.d_model, cfg.d_ff), device)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, attn_impl: str = "blockwise",
                 seq_parallel: bool = False, device=None,
                 weights: bool = True):
        """``device=None`` is the CUDA card, which must be present;
        ``device="cpu"`` runs on the CPU with the kernels' plain
        versions.  ``weights=False`` builds the module without weights
        of its own (its parameters are shapes on the meta device): it
        then runs only on a bound tree, ``loss(params=)``, as a trainer
        whose weights live in the train state does."""
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        for pattern, _ in cfg.stages():
            for spec in pattern:
                if spec.mixer not in MIXERS or spec.ffn not in FFNS:
                    raise ValueError(
                        f"{cfg.name}: unknown layer ({spec.mixer}, "
                        f"{spec.ffn}) (mixers {MIXERS}, FFNs {FFNS})")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.seq_parallel = seq_parallel
        self.device = resolve_device(device)
        self.has_weights = weights
        if self.device.type == "cuda":
            # Projections accumulate in f32 and round once, as the JAX
            # package's (preferred_element_type=f32): no bf16 split-K sums.
            torch.backends.cuda.matmul \
                .allow_bf16_reduced_precision_reduction = False
        norm_params, self.norm_apply = make_norm(cfg.norm)
        self.stages = cfg.stages()
        dev = self.device if weights else torch.device("meta")
        self.embed = nn.Parameter(torch.empty(
            (cfg.padded_vocab, cfg.d_model), dtype=DEFAULT_DTYPE, device=dev),
            requires_grad=False)
        self.final_norm = _norm_params(norm_params, cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty_like(self.embed),
                                     requires_grad=False)
        # Layer order: stage, then unit within the stage, then the
        # pattern's layers (the order of the JAX stacked params).
        self._layer_key = list(_layer_keys(cfg))
        self.layers = nn.ModuleList(
            Block(cfg, spec, norm_params, dev)
            for pattern, repeat in self.stages
            for _ in range(repeat) for spec in pattern)

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0) -> "LM":
        """Fill every weight from ``torch.Generator(device).manual_seed(
        seed)``, one tensor at a time (norm scales 1, biases 0)."""
        self._require_weights("init")
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        embed_init(gen, cfg.padded_vocab, cfg.d_model, out=self.embed)
        if not cfg.tie_embeddings:
            embed_init(gen, cfg.padded_vocab, cfg.d_model, out=self.head)
        norm_params, _ = make_norm(cfg.norm)
        for lp in self.layers:
            if lp.spec.mixer == "gqa":
                gqa_init(gen, d_model=cfg.d_model, num_heads=cfg.num_heads,
                         num_kv_heads=cfg.num_kv_heads,
                         head_dim=cfg.resolved_head_dim, out=lp.mixer)
            elif lp.spec.mixer == "mla":
                mla_init(gen, lp.mixer, d_model=cfg.d_model,
                         **_mla_dims(cfg))
            elif lp.spec.mixer == "mamba":
                mm = cfg.mamba
                mamba_init(gen, lp.mixer, d_model=cfg.d_model,
                           d_state=mm.d_state, d_conv=mm.d_conv,
                           expand=mm.expand)
            else:
                rwkv6_init(gen, lp.mixer, d_model=cfg.d_model)
            if lp.spec.ffn == "mlp":
                for name, (fan_in, fan_out) in mlp_weight_shapes(
                        cfg.d_model, cfg.d_ff, cfg.activation).items():
                    dense_init(gen, fan_in, fan_out, out=lp.ffn[name])
            elif lp.spec.ffn == "moe":
                moe_init(gen, lp.ffn, **_moe_kw(cfg))
            else:
                rwkv6_channel_mix_init(gen, lp.ffn, d_model=cfg.d_model,
                                       d_ff=cfg.d_ff)
        for norm in [self.final_norm] + [
                n for lp in self.layers for n in (lp.mixer_norm,
                                                  lp.ffn_norm)]:
            for name, t in norm_params(cfg.d_model, self.device).items():
                norm[name].copy_(t)
        return self

    def param_paths(self) -> dict:
        """Each parameter's name -> its leaf's path in the JAX ``LM.init``
        tree, in JAX's ``keystr`` spelling (a layer's parameter names its
        stack, ``['stages'][s]['l{j}'][...]``): the sharding rules match
        on it."""
        out = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                si, _, lj, _ = self._layer_key[int(parts[1])]
                parts = ["stages", si, lj] + parts[2:]
            out[name] = "".join(f"[{p!r}]" for p in parts)
        return out

    def _require_weights(self, what: str) -> None:
        if not self.has_weights:
            raise RuntimeError(
                f"LM.{what} needs the module's own weights, and this LM "
                "was built with weights=False: pass a train state's tree "
                "to loss(params=), or build LM(cfg) with its weights")

    def _head(self):
        return self.embed if self.cfg.tie_embeddings else self.head

    # ------------------------------------------------------------------
    # Full-sequence forward (prefill)
    # ------------------------------------------------------------------
    def _positions(self, x, positions):
        """``positions`` as given, or ``0 .. T-1`` for each of x's B rows
        (broadcast to the ``[3, B, T]`` grid with M-RoPE)."""
        if positions is not None:
            return positions
        B, T = x.shape[0], x.shape[1]
        pos = torch.arange(T, dtype=torch.int32,
                           device=x.device)[None, :].expand(B, T)
        return pos[None].expand(3, B, T) if self.cfg.m_rope else pos

    def _embed_in(self, table, tokens, embeds):
        """The input activations: ``embeds`` cast to the embedding's
        dtype (bf16 unless cast, JAX's ``DEFAULT_DTYPE``), else the
        tokens' rows of ``table``."""
        from repro_torch.launch.sharding import shard_batch_dim

        if embeds is not None:
            return shard_batch_dim(embeds.to(table.dtype))
        if tokens is None:
            raise ValueError("give tokens or embeds")
        return shard_batch_dim(embed_apply(table, tokens))

    def _layer_views(self) -> list:
        """Each layer's parameter groups (``mixer_norm``, ``mixer``,
        ``ffn_norm``, ``ffn``) from the module, in layer order."""
        return [{"mixer_norm": lp.mixer_norm, "mixer": lp.mixer,
                 "ffn_norm": lp.ffn_norm, "ffn": lp.ffn}
                for lp in self.layers]

    def bind(self, params) -> dict:
        """A JAX-layout param tree (``stages[s]['l{j}']`` leaves stacked
        ``[repeat, ...]``, as :meth:`stacked_params` makes and the JAX
        ``LM.init`` holds) -> ``{"embed", "head", "final_norm",
        "layers"}`` read as the module's own weights are: ``layers`` has
        each layer's groups as views of the stacked leaves, taken with
        one ``unbind`` a leaf, so autograd gathers a leaf's gradient in
        one ``stack``."""
        cfg = self.cfg
        units = [{lj: _unstack(unit, repeat) for lj, unit in stage.items()}
                 for (_, repeat), stage in zip(self.stages,
                                               params["stages"])]
        layers = [units[si][lj][i] for si, i, lj, _ in _layer_keys(cfg)]
        return {"embed": params["embed"],
                "head": params["embed"] if cfg.tie_embeddings
                else params["head"],
                "final_norm": params["final_norm"], "layers": layers}

    def _own(self) -> dict:
        """:meth:`bind`'s result for the module's own weights."""
        self._require_weights("forward")
        return {"embed": self.embed, "head": self._head(),
                "final_norm": self.final_norm, "layers": self._layer_views()}

    def _layer_full(self, spec, lp, x, positions, aux):
        """One layer over the full sequence -> (x, aux, cache entries:
        {"k", "v"} for GQA, {"ckv", "kr"} for MLA, {"h", "conv"} for
        Mamba, {"x_att", "S", "x_ffn"} for RWKV)."""
        cfg = self.cfg
        c = {}
        h = self.norm_apply(lp["mixer_norm"], x, eps=cfg.norm_eps)
        if spec.mixer == "gqa":
            y, (c["k"], c["v"]) = gqa_apply(
                lp["mixer"], h, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, positions=positions,
                causal=cfg.causal, rope_theta=cfg.rope_theta,
                m_rope=cfg.m_rope, m_rope_sections=cfg.m_rope_sections,
                impl=self.attn_impl, q_block=cfg.attn_q_block,
                kv_block=cfg.attn_kv_block)
        elif spec.mixer == "mla":
            y, (c["ckv"], c["kr"]) = mla_apply(
                lp["mixer"], h, **_mla_dims(cfg), positions=positions,
                causal=cfg.causal, rope_theta=cfg.rope_theta,
                impl=self.attn_impl, q_block=cfg.attn_q_block,
                kv_block=cfg.attn_kv_block)
        elif spec.mixer == "mamba":
            mm = cfg.mamba
            y, (c["h"], c["conv"]) = mamba_apply(
                lp["mixer"], h, d_state=mm.d_state, d_conv=mm.d_conv,
                chunk=mm.chunk, return_state=True, impl=self.attn_impl)
        else:
            y, (c["x_att"], c["S"]) = rwkv6_attn(
                lp["mixer"], h, head_dim=cfg.rwkv_head_dim,
                chunk=cfg.rwkv_chunk, return_state=True,
                impl=self.attn_impl)
        x = x + y
        h = self.norm_apply(lp["ffn_norm"], x, eps=cfg.norm_eps)
        if spec.ffn == "mlp":
            y = mlp_apply(lp["ffn"], h, activation=cfg.activation)
        elif spec.ffn == "moe":
            mo = cfg.moe
            y, aux_l = moe_apply(
                lp["ffn"], h, num_experts=mo.num_experts, top_k=mo.top_k,
                capacity_factor=mo.capacity_factor,
                activation=cfg.activation)
            aux = aux + aux_l
        else:
            y, c["x_ffn"] = rwkv6_channel_mix(lp["ffn"], h,
                                              return_state=True)
        return x + y, aux, c

    def _run_layers(self, x, positions, *, layers=None, collect_cache=False,
                    remat=False):
        """-> (x, the summed MoE aux loss (f32 scalar), per-layer cache
        entries, empty unless ``collect_cache``).  ``layers``: each
        layer's parameter groups (the module's own when ``None``).

        ``remat`` (with grad enabled) runs each pattern unit, the JAX
        package's scanned unit, under ``torch.utils.checkpoint``: its
        activations are recomputed in the backward, as JAX's
        ``nothing_saveable`` policy does."""
        layers = self._layer_views() if layers is None else layers
        specs = [spec for pattern, repeat in self.stages
                 for _ in range(repeat) for spec in pattern]
        caches = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if remat and torch.is_grad_enabled():
            li = 0
            for pattern, repeat in self.stages:
                for _ in range(repeat):
                    unit = list(range(li, li + len(pattern)))
                    li += len(pattern)

                    def body(x, aux, unit=unit):
                        for i in unit:
                            x, aux, _ = self._layer_full(
                                specs[i], layers[i], x, positions, aux)
                            x = self._seq_anchor(x)
                        return x, aux

                    x, aux = checkpoint(body, x, aux, use_reentrant=False)
            return x, aux, caches
        for spec, lp in zip(specs, layers):
            x, aux, c = self._layer_full(spec, lp, x, positions, aux)
            x = self._seq_anchor(x)
            if collect_cache:
                caches.append(c)
        return x, aux, caches

    def _seq_anchor(self, x):
        """``seq_parallel``: the residual's sequence dim over ``model``
        after every layer (:func:`~repro_torch.launch.sharding.
        shard_seq_dim`; the identity with no mesh anchored)."""
        from repro_torch.launch.sharding import shard_seq_dim

        return shard_seq_dim(x) if self.seq_parallel else x

    def _mask_pad(self, logits):
        """-1e30 on the vocab-padding tail (padded_vocab > vocab_size)."""
        cfg = self.cfg
        if cfg.padded_vocab == cfg.vocab_size:
            return logits
        ids = torch.arange(cfg.padded_vocab, device=logits.device)
        return torch.where(ids < cfg.vocab_size, logits, -1e30)

    def _logits(self, p, tokens, embeds, positions, *, remat=False):
        cfg = self.cfg
        x = self._embed_in(p["embed"], tokens, embeds)
        x, aux, _ = self._run_layers(x, self._positions(x, positions),
                                     layers=p["layers"], remat=remat)
        x = self.norm_apply(p["final_norm"], x, eps=cfg.norm_eps)
        return self._mask_pad(unembed_apply(p["head"], x)), aux

    @torch.no_grad()
    def forward(self, tokens=None, *, embeds=None, positions=None,
                remat: bool = False):
        """tokens: i32[B,T] or embeds: [B,T,d_model]; positions: [B,T]
        or ``[3, B, T]`` with M-RoPE (default ``0 .. T-1``) -> (logits
        [B,T,V] f32, moe_aux f32: the Switch aux losses of the MoE
        layers, summed; 0 without any).  No graph is built (the serving
        paths' forward)."""
        return self._logits(self._own(), tokens, embeds, positions,
                            remat=remat)

    def loss(self, batch: dict, *, params, remat: bool = False):
        """batch: {'tokens' | 'embeds', 'labels'} (and optionally
        'positions') -> scalar f32 loss, ``ce + MOE_AUX_WEIGHT * aux``;
        causal models shift internally (labels may equal tokens),
        encoders predict labels frame-wise.

        Runs with grad enabled.  ``params``: a JAX-layout tree whose
        leaves the caller differentiates against (:meth:`bind`; the train
        step's leaves), as JAX's ``loss(params, batch)`` takes them."""
        p = self.bind(params)
        with torch.enable_grad():
            logits, aux = self._logits(
                p, batch.get("tokens"), batch.get("embeds"),
                batch.get("positions"), remat=remat)
            labels = batch["labels"]
            if self.cfg.causal:
                logits = logits[:, :-1]
                labels = labels[:, 1:]
            return cross_entropy_loss(logits, labels) + MOE_AUX_WEIGHT * aux

    @torch.no_grad()
    def stacked_params(self) -> dict:
        """The module's weights as the JAX ``LM.init`` pytree: ``embed``,
        ``final_norm``, ``head`` (untied models), and ``stages`` with
        each stage's layers stacked on a leading ``[repeat]`` axis;
        copies on the model's device, same dtypes."""
        self._require_weights("stacked_params")
        tree = {"embed": self.embed.clone(),
                "final_norm": {k: t.clone()
                               for k, t in self.final_norm.items()},
                "stages": []}
        if not self.cfg.tie_embeddings:
            tree["head"] = self.head.clone()
        stacks: dict = {}
        for si, _, lj, li in _layer_keys(self.cfg):
            for name, t in self.layers[li].named_parameters():
                stacks.setdefault((si, lj, tuple(name.split("."))),
                                  []).append(t)
        for si, (pattern, _) in enumerate(self.stages):
            unit = {f"l{j}": {} for j in range(len(pattern))}
            for (s, lj, path), ts in stacks.items():
                if s == si:
                    _set_path(unit[lj], path, torch.stack(ts))
            tree["stages"].append(unit)
        return tree

    # ------------------------------------------------------------------
    # Decode cache
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeroed caches; K/V, MLA's latents, the mamba conv tail and the RWKV
        token-shift inputs in the activation dtype (the embedding's: bf16,
        as JAX's ``DEFAULT_DTYPE``, unless the model was cast), the
        recurrent states ``h`` and ``S`` in f32.  With a mesh anchored,
        ``DTensor``s at the rules' placements, each rank allocating only
        its shard."""
        from repro_torch.launch.sharding import anchor_mesh, cache_specs

        cfg = self.cfg
        mesh = anchor_mesh()
        dev = self.device if mesh is None else torch.device("meta")
        act = self.embed.dtype
        stages = []
        for pattern, repeat in self.stages:
            unit = {}
            for j, spec in enumerate(pattern):
                c = {}
                if spec.mixer == "gqa":
                    c.update(kvcache.gqa_cache_init(
                        repeat, batch, max_len, cfg.num_kv_heads,
                        cfg.resolved_head_dim, dtype=act, device=dev))
                elif spec.mixer == "mla":
                    c.update(kvcache.mla_cache_init(
                        repeat, batch, max_len, cfg.mla.kv_lora_rank,
                        cfg.mla.qk_rope_head_dim, dtype=act, device=dev))
                elif spec.mixer == "mamba":
                    mm = cfg.mamba
                    c.update(kvcache.mamba_cache_init(
                        repeat, batch, mm.d_inner(cfg.d_model), mm.d_state,
                        mm.d_conv, conv_dtype=act, device=dev))
                else:
                    c.update(kvcache.rwkv_cache_init(
                        repeat, batch, cfg.d_model, cfg.rwkv_head_dim,
                        dtype=act, device=dev))
                if spec.ffn == "rwkv_cm":
                    c["x_ffn"] = torch.zeros((repeat, batch, 1, cfg.d_model),
                                             dtype=act, device=dev)
                unit[f"l{j}"] = c
            stages.append(unit)
        cache = {"stages": stages,
                 "lengths": torch.zeros((batch,), dtype=torch.int32,
                                        device=dev)}
        if mesh is None:
            return cache
        return shards.zeros(cache, mesh, cache_specs(mesh, cache,
                                                     batch=batch),
                            self.device)

    def _layer_caches(self, cache):
        """{name: view of the layer's slice} for each layer, in layer
        order."""
        out = []
        for (pattern, repeat), sc in zip(self.stages, cache["stages"]):
            for i in range(repeat):
                for j in range(len(pattern)):
                    out.append({name: leaf[i]
                                for name, leaf in sc[f"l{j}"].items()})
        return out

    # ------------------------------------------------------------------
    # Decode step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache, tokens):
        """tokens: i32[B,1] -> (logits [B,1,V] f32, cache).

        ``cache['lengths']`` counts tokens BEFORE this step; the new
        token is written at position lengths (0-based) and lengths
        increments.  The cache tensors are updated in place (K/V rows,
        MLA's latent and rope-key rows, the mamba states and conv tails, the RWKV token-shift inputs and
        WKV states of every slot, idle ones too, as JAX's step computes
        them); the returned cache shares them and carries the new
        ``lengths``.  MoE layers run dropless (``moe_apply_dense``).
        """
        self._require_weights("decode_step")
        cfg = self.cfg
        lengths = cache["lengths"] + 1            # incl. the new token
        B = tokens.shape[0]
        pos = (lengths - 1)[:, None]              # [B,1]
        if cfg.m_rope:
            pos = pos[None].expand(3, B, 1)
        x = embed_apply(self.embed, tokens)
        for lp, lc in zip(self.layers, self._layer_caches(cache)):
            h = self.norm_apply(lp.mixer_norm, x, eps=cfg.norm_eps)
            if lp.spec.mixer == "gqa":
                y, _, _ = gqa_decode_apply(
                    lp.mixer, h, lc["k"], lc["v"], lengths,
                    num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.resolved_head_dim, positions=pos,
                    rope_theta=cfg.rope_theta, m_rope=cfg.m_rope,
                    m_rope_sections=cfg.m_rope_sections,
                    impl=self.attn_impl)
            elif lp.spec.mixer == "mla":
                y, _, _ = mla_decode_apply(
                    lp.mixer, h, lc["ckv"], lc["kr"], lengths,
                    **_mla_dims(cfg), positions=pos,
                    rope_theta=cfg.rope_theta)
            elif lp.spec.mixer == "mamba":
                mm = cfg.mamba
                y, st = mamba_decode_step(
                    lp.mixer, h, {"h": lc["h"], "conv": lc["conv"]},
                    d_state=mm.d_state, d_conv=mm.d_conv)
                lc["h"].copy_(st["h"])
                lc["conv"].copy_(st["conv"])
            else:
                y, (x_att, S) = rwkv6_attn_decode(
                    lp.mixer, h, lc["x_att"], lc["S"],
                    head_dim=cfg.rwkv_head_dim)
                lc["x_att"].copy_(x_att)
                lc["S"].copy_(S)
            x = x + y
            h = self.norm_apply(lp.ffn_norm, x, eps=cfg.norm_eps)
            if lp.spec.ffn == "mlp":
                y = mlp_apply(lp.ffn, h, activation=cfg.activation)
            elif lp.spec.ffn == "moe":
                mo = cfg.moe
                y = moe_apply_dense(lp.ffn, h, num_experts=mo.num_experts,
                                    top_k=mo.top_k,
                                    activation=cfg.activation)
            else:
                y, x_ffn = rwkv6_channel_mix(lp.ffn, h, lc["x_ffn"],
                                             return_state=True)
                lc["x_ffn"].copy_(x_ffn)
            x = x + y
        x = self.norm_apply(self.final_norm, x, eps=cfg.norm_eps)
        logits = self._mask_pad(unembed_apply(self._head(), x))
        return logits, {"stages": cache["stages"], "lengths": lengths}

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens=None, max_len: int | None = None, *,
                embeds=None, positions=None):
        """Full-sequence pass that also builds the decode cache; takes
        ``tokens`` or ``embeds`` and ``positions`` as :meth:`forward`.

        Returns (last-token logits [B,V], cache padded to ``max_len``).
        """
        self._require_weights("prefill")
        cfg = self.cfg
        x = self._embed_in(self.embed, tokens, embeds)
        B, T = x.shape[0], x.shape[1]
        max_len = max_len or T
        x, _aux, caches = self._run_layers(x, self._positions(x, positions),
                                           collect_cache=True)
        x = self.norm_apply(self.final_norm, x, eps=cfg.norm_eps)
        logits = self._mask_pad(unembed_apply(self._head(), x[:, -1]))
        full = self.init_cache(B, max_len)
        for tgt, src in zip(self._layer_caches(full), caches):
            for name, val in src.items():
                if name not in SEQ_CACHES:   # recurrent state: set whole
                    tgt[name].copy_(val)
                elif isinstance(val, DTensor):
                    # [B,T,...] padded to max_len rows and copied whole: a
                    # slice of a sequence-sharded cache is no view of it.
                    pad = val.new_zeros((B, max_len - T) + val.shape[2:])
                    tgt[name].copy_(torch.cat([val, pad], dim=1)
                                    if max_len > T else val)
                else:                        # [B,T,...] into [B,max_len,...]
                    tgt[name][:, :T] = val
        full["lengths"].fill_(T)
        return logits, full


# ---------------------------------------------------------------------------
# Weights and caches carried across from the JAX package
# ---------------------------------------------------------------------------

def _to_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype.  bf16 arrays (the
    ``bfloat16`` numpy dtype that JAX arrays convert to) are viewed as
    16-bit integers and then as ``torch.bfloat16``: ``torch.from_numpy``
    rejects the dtype itself."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`_to_tensor`; bf16 comes back as its uint16 bits
    (numpy has no bf16 of its own: ``.view(ml_dtypes.bfloat16)`` on the
    caller's side restores the dtype)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _layer_keys(cfg: ArchConfig):
    """(stage, repeat index, unit layer name, port layer index)."""
    li = 0
    for si, (pattern, repeat) in enumerate(cfg.stages()):
        for i in range(repeat):
            for j in range(len(pattern)):
                yield si, i, f"l{j}", li
                li += 1


def _leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a nested dict, depth first."""
    for name, a in tree.items():
        if isinstance(a, dict):
            yield from _leaves(a, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", a


def params_from_jax(cfg: ArchConfig, tree) -> dict:
    """The JAX ``LM.init`` pytree, as numpy arrays (``jax.tree.map(
    np.asarray, params)``), -> a state dict for :class:`LM`
    (``model.load_state_dict(state)``).  Each stage's leading
    ``[repeat]`` axis is unstacked into the port's layers; nested
    groups (the rwkv mixer's ``mix`` and ``ln_x``, the MoE ``experts``
    stacks ``[repeat, E, ...]``) become dotted keys; empty groups (the
    mamba mixer's ``meta``) carry nothing; every dtype is kept (bf16
    weights, f32 norm scales, routers and SSM parameters)."""
    state = {"embed": _to_tensor(tree["embed"])}
    if not cfg.tie_embeddings:
        state["head"] = _to_tensor(tree["head"])
    for name, a in _leaves(tree["final_norm"]):
        state[f"final_norm.{name}"] = _to_tensor(a)
    for si, i, lj, li in _layer_keys(cfg):
        unit = tree["stages"][si][lj]
        for group in ("mixer_norm", "ffn_norm", "mixer", "ffn"):
            for path, a in _leaves(unit[group]):
                state[f"layers.{li}.{group}.{path}"] = _to_tensor(
                    np.asarray(a)[i])
    return state


def _unstack(tree: dict, n: int) -> list:
    """A nested dict of ``[n, ...]`` leaves -> ``n`` nested dicts of
    views, one ``unbind`` a leaf."""
    out: list = [{} for _ in range(n)]
    for name, a in tree.items():
        parts = _unstack(a, n) if isinstance(a, dict) else a.unbind(0)
        for i in range(n):
            out[i][name] = parts[i]
    return out


def _set_path(tree: dict, path, value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def params_to_numpy(cfg: ArchConfig, state: dict) -> dict:
    """Inverse of :func:`params_from_jax`: the JAX pytree layout, with
    each stage's layers stacked on a leading ``[repeat]`` axis; bf16
    tensors come back as their uint16 bits."""
    tree = {"embed": _to_numpy(state["embed"]),
            "final_norm": {}, "stages": []}
    if not cfg.tie_embeddings:
        tree["head"] = _to_numpy(state["head"])
    for key, t in state.items():
        if key.startswith("final_norm."):
            _set_path(tree["final_norm"], key.split(".")[1:], _to_numpy(t))
    stacks: dict = {}
    for si, i, lj, li in _layer_keys(cfg):
        prefix = f"layers.{li}."
        for key, t in state.items():
            if key.startswith(prefix):
                path = tuple(key[len(prefix):].split("."))
                stacks.setdefault((si, lj, path), []).append(_to_numpy(t))
    for si, (pattern, _) in enumerate(cfg.stages()):
        unit = {f"l{j}": {} for j in range(len(pattern))}
        for (s, lj, path), arrs in stacks.items():
            if s == si:
                _set_path(unit[lj], path, np.stack(arrs))
        tree["stages"].append(unit)
    return tree


def cache_from_jax(cache, device="cpu") -> dict:
    """A JAX decode cache (numpy leaves) -> the port's cache dict on
    ``device``, same layout and dtypes."""
    return {
        "stages": [{lj: {name: _to_tensor(a).to(device)
                         for name, a in layer.items()}
                    for lj, layer in stage.items()}
                   for stage in cache["stages"]],
        "lengths": _to_tensor(cache["lengths"]).to(device),
    }
