"""Architecture configuration system (the PyTorch port's own copy of
:mod:`repro.configs.base`: pure data, kept here because the port does
not import ``repro``; it must stay equal to the JAX package's).

One :class:`ArchConfig` per assigned architecture (see configs/<id>.py),
resolvable by name via :func:`get_config`.  Configs are *exact* public
configurations; ``reduced()`` derives the small same-family variant used
by the CPU smoke tests (few layers, narrow width, tiny vocab, few
experts), as required by the brief.

The layer stack is described by ``block_pattern`` — a tuple of
``(mixer, ffn)`` layer specs that is tiled ``num_layers / len(pattern)``
times (in the JAX package each homogeneous run is one ``lax.scan`` over
stacked params; the port loops over its layers).  Examples:

    dense:    ((gqa, mlp),)                         × L
    granite:  ((gqa, moe),)                         × 24
    deepseek: ((mla, mlp),) first layer, ((mla, moe),) × 26
    jamba:    ((gqa, mlp), (mamba, moe), (mamba, mlp), ... 8 layers) × 9
    rwkv6:    ((rwkv, rwkv_cm),)                    × 24
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# ---------------------------------------------------------------------------
# Sub-specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLASpec:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str   # "gqa" | "mla" | "mamba" | "rwkv"
    ffn: str     # "mlp" | "moe" | "rwkv_cm"


# ---------------------------------------------------------------------------
# ArchConfig
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    causal: bool = True
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    rope_theta: float = 10000.0
    m_rope: bool = False
    m_rope_sections: tuple = (16, 24, 24)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE / MLA / SSM specs
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    mamba: Optional[MambaSpec] = None
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64
    # layer layout
    block_pattern: tuple = (LayerSpec("gqa", "mlp"),)
    first_layer_pattern: Optional[tuple] = None  # e.g. deepseek dense layer 0
    # shape applicability
    supports_decode: bool = True
    subquadratic: bool = False   # can run long_500k
    input_mode: str = "tokens"   # tokens | embeds (audio/vlm frontend stub)
    # attention impl knobs
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    notes: str = ""

    # -- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a 256 multiple so the vocab
        dim shards evenly over the 16-way model axis (the standard
        production treatment of odd vocabs like granite's 49155 or
        minicpm's 122753).  Logits beyond ``vocab_size`` are masked to
        -inf by the model."""
        return -(-self.vocab_size // 256) * 256

    def stages(self):
        """List of (pattern: tuple[LayerSpec], repeat: int)."""
        out = []
        n = self.num_layers
        if self.first_layer_pattern is not None:
            k = len(self.first_layer_pattern)
            out.append((self.first_layer_pattern, 1))
            n -= k
        p = len(self.block_pattern)
        if n % p:
            raise ValueError(
                f"{self.name}: {n} layers not divisible by pattern {p}"
            )
        out.append((self.block_pattern, n // p))
        return out

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline numbers)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for pattern, repeat in self.stages():
            per = 0
            for spec in pattern:
                if spec.mixer == "gqa":
                    per += d * self.num_heads * hd       # q
                    per += 2 * d * self.num_kv_heads * hd
                    per += self.num_heads * hd * d       # o
                elif spec.mixer == "mla":
                    m = self.mla
                    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    per += d * self.num_heads * qd
                    per += d * m.kv_lora_rank + d * m.qk_rope_head_dim
                    per += m.kv_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    per += self.num_heads * m.v_head_dim * d
                elif spec.mixer == "mamba":
                    mm = self.mamba
                    di = mm.d_inner(d)
                    dtr = max(1, math.ceil(d / 16))
                    per += d * 2 * di + mm.d_conv * di
                    per += di * (dtr + 2 * mm.d_state) + dtr * di
                    per += di * mm.d_state + di  # A, D
                    per += di * d
                elif spec.mixer == "rwkv":
                    per += 5 * d * d + 2 * d * 64  # r,k,v,g,o + decay lora
                if spec.ffn == "mlp":
                    mult = 3 if self.activation in ("swiglu", "geglu") else 2
                    per += mult * d * self.d_ff
                elif spec.ffn == "moe":
                    mo = self.moe
                    mult = 3 if self.activation in ("swiglu", "geglu") else 2
                    per += mo.num_experts * mult * d * mo.d_ff_expert
                    per += d * mo.num_experts  # router
                    if mo.num_shared:
                        per += mult * d * mo.d_ff_expert * mo.num_shared
                elif spec.ffn == "rwkv_cm":
                    per += 2 * d * self.d_ff + d * d
            total += per * repeat
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k only) for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        dense_version = dataclasses.replace(
            self,
            moe=dataclasses.replace(
                self.moe,
                num_experts=self.moe.top_k,
            ),
        )
        # count with only top_k routed experts "active"
        return dense_version.param_count()

    # -- reduced smoke-test variant ------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Small same-family config: runs a forward/train step on CPU."""
        d_small = 64
        heads = max(2, min(4, self.num_heads))
        kv = heads if self.num_kv_heads == self.num_heads else 2
        pattern_len = len(self.block_pattern)
        extra = len(self.first_layer_pattern or ())
        layers = pattern_len * (2 if pattern_len <= 4 else 1) + extra
        kw = dict(
            name=self.name + "-reduced",
            num_layers=layers,
            d_model=d_small,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_small // heads,
            d_ff=128,
            vocab_size=256,
            attn_q_block=16,
            attn_kv_block=16,
            rwkv_head_dim=16,
            rwkv_chunk=8,
        )
        if self.moe is not None:
            # capacity_factor = E/K makes capacity == N: provably no
            # drops, so batched and incremental MoE agree exactly in the
            # decode-vs-forward cross-check.
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(2, self.moe.top_k),
                d_ff_expert=32,
                num_shared=min(1, self.moe.num_shared),
                capacity_factor=2.0,
            )
        if self.mla is not None:
            kw["mla"] = MLASpec(kv_lora_rank=32, qk_nope_head_dim=16,
                                qk_rope_head_dim=8, v_head_dim=16)
        if self.mamba is not None:
            kw["mamba"] = dataclasses.replace(self.mamba, d_state=4, chunk=8)
        if self.m_rope:
            hd = kw["head_dim"]
            kw["m_rope_sections"] = (hd // 2 - 2 * (hd // 8), hd // 8,
                                     hd // 8)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register_config(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib

    for mod in [
        "stablelm_12b", "llama3_405b", "minicpm_2b", "phi4_mini_3_8b",
        "jamba_1_5_large", "granite_moe_1b", "deepseek_v2_lite",
        "rwkv6_1_6b", "hubert_xlarge", "qwen2_vl_72b",
    ]:
        importlib.import_module(f"repro_torch.configs.{mod}")


# Shape suites assigned to the LM family (the brief's 4 shapes).
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the brief's skip rules."""
    spec = SHAPES[shape_name]
    if spec["kind"] == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch; 500k needs sub-quadratic"
    return True, ""
