"""Shared neural-net layers (PyTorch port of :mod:`repro.models.layers`).

Functions on tensors with dict-like parameters (plain dicts or
``nn.ParameterDict``), in the JAX package's layouts.  Weights are bf16
with f32 norm scales.  Projections accumulate in f32: their result is
f32, or rounded once to the activation dtype — what ``proj_einsum``
does with ``PREFER_F32_PROJ=True`` (that §Perf knob is not ported).
Initializers draw from an explicit ``torch.Generator``.

On a device mesh (``DTensor`` weights and activations) each layer runs
on the ranks' shards (:mod:`repro_torch.models.shards`) and takes JAX's
anchor on the unembedding table from :mod:`repro_torch.launch.sharding`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import shards as sh

DEFAULT_DTYPE = torch.bfloat16


def proj(x, w, out_dtype=None):
    """``x[..., d] @ w[d, f]`` accumulated in f32; returns f32, or the
    f32 result rounded once to ``out_dtype``.

    On the card a product that autograd records (a training step's)
    takes the CPU's route, f32 operands: the mixed-dtype ``torch.mm(...,
    out_dtype=)`` has no derivative.  On ``DTensor``s the product is a
    tensor-parallel one on each rank's shards (:func:`_proj_shards`)."""
    if isinstance(w, sh.DTensor):
        return _proj_shards(x, w, out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype == w.dtype and (w.dtype == torch.float32
                                               or out_dtype == w.dtype):
        # cuBLAS accumulates a bf16 product in f32 and rounds once
        # (LM turns off its reduced-precision split-K reductions);
        # f32 operands give f32 (TF32 stays off by default).
        y = x2 @ w
    elif x2.is_cuda and not (torch.is_grad_enabled()
                             and (x2.requires_grad or w.requires_grad)):
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    y = y.reshape(*lead, w.shape[-1])
    return y if out_dtype is None else y.to(out_dtype)


def _proj_shards(x, w, out_dtype):
    """:func:`proj` of ``DTensor``s as FSDP and tensor parallelism run it:
    the weight's ``data`` shards are gathered (ZeRO-3), its ``model``
    split kept; a column-parallel weight (out dim over ``model``) takes
    x whole over ``model`` (a sequence-parallel x is gathered) and gives
    y split in its last dim, a row-parallel one (in dim over ``model``)
    takes x split in its last dim and all-reduces the partial sums.  x
    keeps its batch split, so no rank computes another's rows."""
    mesh = w.device_mesh
    last = x.ndim - 1
    w_pl, x_pl, y_pl = [], [], []
    for name, wp, xp in zip(mesh.mesh_dim_names, w.placements,
                            x.placements):
        if name != "model":
            wp = sh.Replicate()
        if isinstance(wp, sh.Shard) and wp.dim == 0:      # row-parallel
            xp, yp = sh.Shard(last), sh.Partial()
        elif isinstance(wp, sh.Shard):                    # column-parallel
            xp, yp = sh.Replicate(), sh.Shard(last)
        else:
            if xp.is_partial() or (isinstance(xp, sh.Shard)
                                   and xp.dim == last):
                xp = sh.Replicate()
            yp = xp
        w_pl.append(wp)
        x_pl.append(xp)
        y_pl.append(yp)
    y = sh.on_shards(lambda a, b: proj(a, b, out_dtype=out_dtype),
                     (x, w), (tuple(x_pl), tuple(w_pl)), tuple(y_pl))
    if any(pl.is_partial() for pl in y_pl):     # the row-parallel reduce
        y = y.redistribute(mesh, [sh.Replicate() if pl.is_partial() else pl
                                  for pl in y_pl])
    return y


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               out=None):
    """Truncated-normal fan-in init in bf16: the normal is cut at ±2
    before it is scaled by ``1/sqrt(in_dim)``, as the JAX ``dense_init``
    does.  ``out`` (an ``[in_dim, out_dim]`` tensor) is filled in place
    and returned."""
    std = 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.mul_(std)
    return w.to(DEFAULT_DTYPE) if out is None else out.copy_(w)


def embed_init(gen: torch.Generator, vocab: int, dim: int, *, out=None):
    """Normal init in bf16 scaled by ``1/sqrt(dim)``; ``out`` as in
    :func:`dense_init`."""
    w = torch.empty((vocab, dim), dtype=torch.float32, device=gen.device)
    w.normal_(generator=gen)
    w.mul_(1.0 / math.sqrt(dim))
    return w.to(DEFAULT_DTYPE) if out is None else out.copy_(w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_params(dim: int, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def _whole_rows(x):
    """A ``DTensor`` with its last dim whole on every rank (gathered) and
    no partial sums: a norm reduces over that dim."""
    if not isinstance(x, sh.DTensor):
        return x
    last = x.ndim - 1
    pl = [sh.Replicate() if p.is_partial() or (isinstance(p, sh.Shard)
                                               and p.dim == last) else p
          for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def rmsnorm(params, x, *, eps: float = 1e-5):
    x = _whole_rows(x)
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def layernorm_params(dim: int, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layernorm(params, x, *, eps: float = 1e-5):
    x = _whole_rows(x)
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)


def make_norm(kind: str):
    """``(params(dim, device), apply(params, x, eps=))`` for a norm kind."""
    if kind == "rmsnorm":
        return rmsnorm_params, rmsnorm
    if kind == "layernorm":
        return layernorm_params, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies f32[head_dim // 2]."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x, positions, *, theta: float = 10000.0):
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) by position angles.

    x: [..., T, H, D]; positions: broadcastable to [..., T].  The "split
    halves" convention (llama-style), in f32.
    """
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    angles = positions.float()[..., None] * inv      # [..., T, d/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_m_rope(x, positions_thw, *, theta: float = 10000.0,
                 sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE: the head dim's rotation pairs split
    into (temporal, height, width) sections, each rotated by its own
    position stream.  x: [..., T, H, D]; ``positions_thw``: [3, ..., T];
    ``sections`` count *pairs* and sum to D // 2.  Angles in f32, as
    :func:`apply_rope`."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"m_rope sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {d // 2}")
    inv = rope_freqs(d, theta, x.device)
    # Each section's pairs by its own stream; no index tensor, so no copy
    # to the card and no read back from it.
    ends = [sum(sections[:i + 1]) for i in range(3)]
    angles = torch.cat(
        [positions_thw[i].float()[..., None] * inv[end - n:end]
         for i, (n, end) in enumerate(zip(sections, ends))],
        dim=-1)                                            # [..., T, d/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_weight_shapes(d_model: int, d_ff: int, activation: str) -> dict:
    """Name -> shape of an MLP's weights, in init order."""
    names = (("gate", "up", "down") if activation in ("swiglu", "geglu")
             else ("up", "down"))
    return {n: ((d_ff, d_model) if n == "down" else (d_model, d_ff))
            for n in names}


def mlp_apply(params, x, *, activation: str = "swiglu"):
    dtype = x.dtype
    if activation in ("swiglu", "geglu"):
        g = proj(x, params["gate"])
        u = proj(x, params["up"])
        act = F.silu(g) if activation == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = (act * u).to(dtype)
    elif activation == "gelu":
        u = proj(x, params["up"])
        h = F.gelu(u, approximate="tanh").to(dtype)   # jax.nn.gelu default
    else:
        raise ValueError(activation)
    return proj(h, params["down"], out_dtype=dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_apply(embedding, tokens):
    """The tokens' rows of the table.  On a mesh (``DTensor``s) each rank
    looks its batch shard's ids up in its vocab shard of the table (the
    other dim gathered), and the ranks of a ``model`` group hold partial
    sums, each row on the rank of its vocab shard."""
    if not isinstance(embedding, sh.DTensor):
        return embedding[tokens]
    mesh = embedding.device_mesh
    vocab = sh.split_spec(embedding, {0: "model"})[0]
    rows = sh.split_spec(tokens, {0: "batch"})[0]

    def local(table, ids):
        if vocab is None:
            return table[ids]
        n = table.shape[0]
        ids = ids - mesh.get_local_rank("model") * n
        hit = ((ids >= 0) & (ids < n))[..., None]
        return torch.where(hit, table[ids.clamp(0, n - 1)], 0.0).to(
            table.dtype)

    out = tuple(sh.Partial() if name == "model" and vocab is not None else
                sh.Shard(0) if name in (rows or ()) else sh.Replicate()
                for name in mesh.mesh_dim_names)
    return sh.on_shards(local, (embedding, tokens),
                        (sh.P(vocab, None),
                         sh.P(rows, *(None,) * (tokens.ndim - 1))),
                        out)


def unembed_apply(embedding_or_head, x):
    """Logits in f32: ``x[..., d] · head[v, d]``.  On a mesh the head is
    constrained to ``P('model', None)`` first, so the product contracts
    a replicated d (:func:`~repro_torch.launch.sharding.
    gather_head_for_unembed`)."""
    from repro_torch.launch.sharding import gather_head_for_unembed

    return proj(x, gather_head_for_unembed(embedding_or_head).t())


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits, labels, *, ignore_id: int = -1):
    """Mean token NLL in f32; ``labels == ignore_id`` masked out, the
    mean taken over ``max(sum(mask), 1)`` tokens."""
    logits = logits.float()
    if isinstance(logits, sh.DTensor):
        logz, gold = _logz_gold_shards(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(
            labels, min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _logz_gold_shards(logits, labels):
    """``logsumexp`` and the label's logit of vocab-sharded ``DTensor``
    logits (the vocab-parallel cross entropy): the max, the sum of exps
    and the label's logit reduce over the ranks that split the vocab."""
    mesh = logits.device_mesh
    rows = sh.spec_of(logits)[0]
    labels = torch.clamp(labels, min=0).long()
    row_pl = tuple(sh.Shard(0) if rows and name in rows else sh.Replicate()
                   for name in mesh.mesh_dim_names)
    if not sh.sharded_over(logits, logits.ndim - 1):
        # a whole vocab a rank: the plain formulas on each rank's rows
        return sh.on_shards(
            lambda lg, ids: (torch.logsumexp(lg, dim=-1), torch.gather(
                lg, -1, ids[..., None])[..., 0]),
            (logits, labels),
            (sh.P(rows, *(None,) * (logits.ndim - 1)),
             sh.P(rows, *(None,) * (labels.ndim - 1))), (row_pl, row_pl))
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    logz = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    vocab = sh.spec_of(logits)[-1]
    v0 = sh.block_offset(logits, logits.ndim - 1)

    def local(lg, ids):
        n = lg.shape[-1]
        ids = ids - v0
        hit = (ids >= 0) & (ids < n)
        got = torch.gather(lg, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(hit, got, 0.0)

    out = tuple(sh.Partial() if vocab and name in vocab else
                sh.Shard(0) if rows and name in rows else sh.Replicate()
                for name in mesh.mesh_dim_names)
    gold = sh.on_shards(local, (logits, labels),
                        (sh.spec_of(logits),
                         sh.P(rows, *(None,) * (labels.ndim - 1))), out)
    return logz, gold
