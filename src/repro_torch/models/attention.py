"""GQA and MLA attention (PyTorch port of :mod:`repro.models.attention`).

Three execution paths, selected by ``impl`` as in the JAX package:

* ``"blockwise"`` (default) — flash-style attention in plain PyTorch:
  Python loops over query and KV blocks with a running (max, denominator)
  in f32; causal KV blocks wholly in the future are skipped.
* ``"reference"`` — naive full-matrix softmax attention, the oracle.
* ``"pallas"`` — the hand-written Hopper kernels
  (:mod:`repro_torch.kernels.ops`), the counterparts of the JAX
  package's Pallas kernels.  The name is kept so that both packages line
  up; on CPU tensors the kernels' plain versions run.

Decode writes the new token's K/V into a dense cache and attends with
full-length masking.  Unlike the JAX package, decode updates the cache
tensors IN PLACE (no copy of the ``[B, S, KV, D]`` cache per layer) and
returns them.  GQA takes M-RoPE (``m_rope=True``: a ``[3, B, T]``
position grid, :func:`~repro_torch.models.layers.apply_m_rope`).

MLA (DeepSeek's multi-head latent attention): :func:`mla_apply` is the
full-sequence form without absorption and returns the compressed cache
entries ``(c_kv, k_rope)``; :func:`mla_decode_apply` is the
weight-absorbed decode over the ``kv_lora_rank + rope_dim`` latent cache,
in plain torch as in the JAX package.  Under ``impl="pallas"`` MLA
prefill runs ``flash_attention`` at qk head dim ``dn + dr`` (k_rope
broadcast to every head, v zero-padded to that width and the output
sliced back), where JAX's ``mla_apply`` runs ``blockwise``: the same
function, since the kernel's ``1/sqrt(D)`` is JAX's ``1/sqrt(dn + dr)``.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import shards
from repro_torch.models.layers import (
    DEFAULT_DTYPE,
    apply_m_rope,
    apply_rope,
    dense_init,
    proj,
    rmsnorm,
)

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Reference attention (oracle)
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, *, causal: bool):
    """q: [B,T,H,D], k/v: [B,S,KV,D] with H = KV*G.  f32 softmax."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, KV, G, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(T, device=q.device)
        mask = qpos[:, None] >= torch.arange(S, device=q.device)[None, :]
        logits = torch.where(mask[None, None, None], logits, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention in plain PyTorch
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, *, causal: bool, q_block: int = 512,
                        kv_block: int = 1024):
    """Numerically exact flash-style attention, O(T·kv_block) memory.

    Requires k/v already expanded to H heads (``expand_kv``), as the JAX
    function does.  The JAX ``lax.scan``s become Python loops and its
    ``lax.cond`` block skip (``skip_masked_blocks``, on by default there
    and always here) a Python ``if`` on block indices.
    """
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if KV != H:
        raise ValueError("blockwise_attention requires expanded KV heads "
                         f"(got H={H}, KV={KV}); use expand_kv()")
    scale = 1.0 / math.sqrt(D)
    q_block = min(q_block, T)
    kv_block = min(kv_block, S)
    Tp = -(-T // q_block) * q_block
    Sp = -(-S // kv_block) * kv_block
    dev = q.device
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, 0, 0, Tp - T))
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, Sp - S))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, Sp - S))
    nq, nk = Tp // q_block, Sp // kv_block

    outs = []
    for qi in range(nq):
        qblk = qf[:, qi * q_block:(qi + 1) * q_block]     # [B,qb,H,D]
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, H, q_block), _NEG_INF, device=dev)
        l = torch.zeros((B, H, q_block), device=dev)
        acc = torch.zeros((B, H, q_block, D), device=dev)
        for ki in range(nk):
            if causal and ki * kv_block > qi * q_block + q_block - 1:
                continue              # the whole KV block is in the future
            kblk = kf[:, ki * kv_block:(ki + 1) * kv_block]
            vblk = vf[:, ki * kv_block:(ki + 1) * kv_block]
            s = torch.einsum("bqhd,bshd->bhqs", qblk, kblk) * scale
            kv_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            valid = (kv_pos < S)[None, :]
            if causal:
                valid = valid & (q_pos[:, None] >= kv_pos[None, :])
            s = torch.where(valid[None, None], s, _NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bhqs,bshd->bhqd", p, vblk)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # [B,H,qb,D]
        outs.append(out.transpose(1, 2))                     # [B,qb,H,D]
    return torch.cat(outs, dim=1)[:, :T].to(q.dtype)


def expand_kv(k, G: int):
    """[B,S,KV,D] -> [B,S,KV*G,D]: replicate each KV head for its G
    query heads."""
    if G == 1:
        return k
    B, S, KV, D = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, G, D).reshape(B, S, KV * G, D)


def _cache_dot(spec: str, a, b):
    """An einsum in the cache dtype, as XLA's bf16 dot: products summed
    in f32 and rounded once to the operands' dtype."""
    if a.is_cuda:
        return torch.einsum(spec, a, b)     # cuBLAS: f32 sums, one rounding
    return torch.einsum(spec, a.float(), b.float()).to(a.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, offset: int = 0,
                     reduce=None):
    """Single-token attention against a dense KV cache (the plain path).

    q: [B,H,D]; k_cache/v_cache: [B,S,KV,D]; cache_len: i32[B] valid
    lengths (the new token's position is cache_len-1 inclusive).

    The cache-touching dots run in the CACHE dtype (bf16), as the JAX
    function's do; only the [B,H,S] scores are f32.  The decode kernel
    (``impl="pallas"``) accumulates in f32 throughout, so the two paths
    differ by bf16 roundings and are each compared with their own
    counterpart.

    A cache that holds one block of the positions, from ``offset``, is
    one rank's shard of a cache whose sequence dim is split:
    ``reduce(t, op)`` (``op`` ``"max"`` or ``"sum"``) then combines ``t``
    over the ranks, and the softmax is a partial one (the max, the
    denominator and the weighted values reduced), as XLA lowers
    attention over a sharded length.
    """
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D).to(k_cache.dtype)
    s = _cache_dot("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    pos = offset + torch.arange(S, device=q.device)
    valid = pos[None, :] < cache_len[:, None]
    s = torch.where(valid[:, None, None], s, _NEG_INF)
    if reduce is None:
        w = torch.softmax(s, dim=-1)
    else:
        p = torch.exp(s - reduce(torch.amax(s, dim=-1, keepdim=True), "max"))
        w = p / reduce(torch.sum(p, dim=-1, keepdim=True), "sum")
    out = _cache_dot("bkgs,bskd->bkgd", w.to(v_cache.dtype), v_cache)
    if reduce is not None:     # each rank's bf16 share, summed in f32
        out = reduce(out.float(), "sum")
    return out.reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_weight_shapes(*, d_model: int, num_heads: int, num_kv_heads: int,
                      head_dim: int) -> dict:
    """Name -> shape of the GQA weights, in init order."""
    return {
        "wq": (d_model, num_heads * head_dim),
        "wk": (d_model, num_kv_heads * head_dim),
        "wv": (d_model, num_kv_heads * head_dim),
        "wo": (num_heads * head_dim, d_model),
    }


def gqa_init(gen: torch.Generator, *, d_model: int, num_heads: int,
             num_kv_heads: int, head_dim: int, out=None) -> dict:
    """Fan-in truncated-normal GQA weights drawn from ``gen``; ``out``
    (a dict-like of tensors of these shapes) is filled in place."""
    shapes = gqa_weight_shapes(d_model=d_model, num_heads=num_heads,
                               num_kv_heads=num_kv_heads, head_dim=head_dim)
    params = {} if out is None else out
    for name, (fan_in, fan_out) in shapes.items():
        w = dense_init(gen, fan_in, fan_out,
                       out=None if out is None else out[name])
        if out is None:
            params[name] = w
    return params


def _project_qkv(params, x, *, num_heads, num_kv_heads, head_dim):
    B, T, _ = x.shape
    q = proj(x, params["wq"], out_dtype=x.dtype)
    k = proj(x, params["wk"], out_dtype=x.dtype)
    v = proj(x, params["wv"], out_dtype=x.dtype)
    return (shards.split_last(q, (num_heads, head_dim)),
            shards.split_last(k, (num_kv_heads, head_dim)),
            shards.split_last(v, (num_kv_heads, head_dim)))


def _rotate(q, k, positions, *, theta, m_rope, sections):
    """RoPE (or M-RoPE) on q and k, as the JAX functions apply it."""
    if m_rope:
        return (apply_m_rope(q, positions, theta=theta, sections=sections),
                apply_m_rope(k, positions, theta=theta, sections=sections))
    if positions is not None:
        return (apply_rope(q, positions, theta=theta),
                apply_rope(k, positions, theta=theta))
    return q, k


def _attend(impl: str, q, k, v, *, causal: bool, q_block: int = 512,
            kv_block: int = 1024):
    """The attention core of ``impl`` on q [B,T,H,D] and k/v [B,S,KV,D]
    (KV dividing H).  On ``DTensor``s it runs on each rank's shards
    (:func:`repro_torch.models.shards.on_shards`): batch over the DP
    axes and heads over ``model`` where they divide (k/v expanded to H
    heads first when KV does not), so a kernel sees plain tensors."""
    def core(q, k, v):
        if impl == "reference":
            return reference_attention(q, k, v, causal=causal)
        if impl == "blockwise":
            G = q.shape[2] // k.shape[2]
            return blockwise_attention(q, expand_kv(k, G), expand_kv(v, G),
                                       causal=causal, q_block=q_block,
                                       kv_block=kv_block)
        if impl == "pallas":
            from repro_torch.kernels import ops as kops
            return kops.flash_attention(q, k, v, causal=causal)
        raise ValueError(impl)

    if not isinstance(q, DTensor):
        return core(q, k, v)
    heads = {0: "batch", 2: "model"}
    qs, ks = shards.split_spec(q, heads), shards.split_spec(k, heads)
    if qs[2] is not None and ks[2] is None:   # KV does not split as H does
        G = q.shape[2] // k.shape[2]
        k, v = expand_kv(k, G), expand_kv(v, G)
        ks = shards.split_spec(k, heads)
    if qs[2] is None:                         # whole heads on every rank
        ks = shards.split_spec(k, {0: "batch"})
    return shards.on_shards(core, (q, k, v), (qs, ks, ks), qs)


def gqa_apply(params, x, *, num_heads: int, num_kv_heads: int,
              head_dim: int, positions, causal: bool = True,
              rope_theta: float = 10000.0, m_rope: bool = False,
              m_rope_sections=(16, 24, 24), impl: str = "blockwise",
              q_block: int = 512, kv_block: int = 1024):
    """Full-sequence (train/prefill) GQA.  Returns (y, (k, v)) so callers
    can build the KV cache during prefill.  With ``m_rope``,
    ``positions`` is the ``[3, B, T]`` grid."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(params, x, num_heads=num_heads,
                           num_kv_heads=num_kv_heads, head_dim=head_dim)
    q, k = _rotate(q, k, positions, theta=rope_theta, m_rope=m_rope,
                   sections=m_rope_sections)
    o = _attend(impl, q, k, v, causal=causal, q_block=q_block,
                kv_block=kv_block)
    y = proj(o.reshape(B, T, num_heads * head_dim), params["wo"],
             out_dtype=x.dtype)
    return y, (k, v)


def gqa_decode_apply(params, x, cache_k, cache_v, cache_len, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     positions, rope_theta: float = 10000.0,
                     m_rope: bool = False, m_rope_sections=(16, 24, 24),
                     impl: str = "blockwise"):
    """One-token decode.  x: [B,1,d]; cache_*: [B,S,KV,D]; cache_len:
    i32[B] length INCLUDING the new token; ``positions`` [B,1] (or
    ``[3, B, 1]`` with ``m_rope``).  Writes the new K/V into the caches in
    place and returns (y, cache_k, cache_v)."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, num_heads=num_heads,
                           num_kv_heads=num_kv_heads, head_dim=head_dim)
    q, k = _rotate(q, k, positions, theta=rope_theta, m_rope=m_rope,
                   sections=m_rope_sections)
    idx = cache_len - 1
    _scatter_token(cache_k, k[:, 0], idx)
    _scatter_token(cache_v, v[:, 0], idx)
    if impl == "pallas":
        o = _decode_kernel(q[:, 0], cache_k, cache_v, cache_len)
    elif isinstance(cache_k, DTensor):
        o = _decode_shards(q[:, 0], cache_k, cache_v, cache_len)
    else:
        o = decode_attention(q[:, 0], cache_k, cache_v, cache_len)
    y = proj(o.reshape(B, num_heads * head_dim), params["wo"],
             out_dtype=x.dtype)
    return y[:, None, :], cache_k, cache_v


def _decode_shards(q, cache_k, cache_v, cache_len):
    """:func:`decode_attention` on a ``DTensor`` cache, on each rank's
    shard: q and the lengths take the cache's batch split; a rank whose
    cache holds a block of the positions scores that block, and the
    softmax is combined over the sequence axes with
    ``_c10d_functional.all_reduce``s."""
    from torch.distributed import _functional_collectives as funcol

    mesh = cache_k.device_mesh
    groups = [(mesh, mesh.mesh_dim_names.index(a))
              for a in shards.sharded_over(cache_k, 1)]

    def reduce(t, op):
        for g in groups:
            t = funcol.all_reduce(t, op, g)
        return t

    off = shards.block_offset(cache_k, 1)

    def local(q, k_cache, v_cache, cache_len):
        return decode_attention(q, k_cache, v_cache, cache_len, offset=off,
                                reduce=reduce if groups else None)

    cs = shards.spec_of(cache_k)
    qs = shards.P(cs[0], None, None)
    return shards.on_shards(local, (q, cache_k, cache_v, cache_len),
                            (qs, cs, cs, shards.P(cs[0])), qs)


def _decode_kernel(q, cache_k, cache_v, cache_len):
    """The ``decode_attention`` kernel; on ``DTensor``s, on each rank's
    batch shard.  A cache whose sequence dim is sharded (the decode
    cells' layout, ``launch.sharding.cache_specs``) would need a
    partial softmax across ranks, which the kernel does not compute:
    it raises, naming the placement, rather than run the plain version."""
    from repro_torch.kernels import ops as kops

    if not isinstance(cache_k, DTensor):
        return kops.decode_attention(q, cache_k, cache_v, cache_len)
    over = shards.sharded_over(cache_k, 1)
    if over:
        raise NotImplementedError(
            f"decode_attention on a cache whose sequence dim is sharded "
            f"over {over} (placements {cache_k.placements}): the kernel "
            "takes a whole sequence a rank")
    b = {0: "batch"}
    cs = shards.split_spec(cache_k, b)
    return shards.on_shards(
        kops.decode_attention, (q, cache_k, cache_v, cache_len),
        (shards.split_spec(q, b), cs, cs, shards.split_spec(cache_len, b)),
        shards.split_spec(q, b))


def _scatter_token(cache, new, idx):
    """cache[b, idx[b]] = new[b] in place; cache: [B,S,...] (K/V
    [B,S,KV,D], MLA's latent rows [B,S,R]); new: [B,...]; idx: i32[B].

    As JAX's ``.at[].set``: a negative index counts from the end, and a
    row whose index is still outside ``[0, S)`` is dropped.  Serving
    reaches that: an idle slot's length keeps growing past ``max_len``.
    The write is masked on the device, with no host read."""
    if isinstance(cache, DTensor):
        return _scatter_token_shards(cache, new, idx)
    S = cache.shape[1]
    idx = idx.long()
    _write_rows(cache, new, torch.where(idx < 0, idx + S, idx))
    return cache


def _write_rows(cache, new, idx) -> None:
    """cache[b, idx[b]] = new[b] where ``0 <= idx[b] < S``, masked on
    the device."""
    B, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    keep = (idx >= 0) & (idx < S)
    safe = torch.clamp(idx, 0, S - 1)
    old = cache[rows, safe]
    keep = keep.reshape((B,) + (1,) * (cache.ndim - 2))
    cache[rows, safe] = torch.where(keep, new.to(cache.dtype), old)


def _scatter_token_shards(cache, new, idx):
    """:func:`_scatter_token` into a ``DTensor`` cache, on each rank's
    shard in place: ``new`` and ``idx`` take the cache's batch split,
    and a rank whose sequence shard starts at ``off`` writes the rows
    whose index falls in ``[off, off + S_local)``."""
    mesh = cache.device_mesh
    rows = shards.spec_of(cache)[0]
    new = new.redistribute(mesh, shards.placements(mesh, shards.P(
        rows, *(None,) * (new.ndim - 1)))).to_local()
    idx = idx.redistribute(mesh, shards.placements(
        mesh, shards.P(rows))).to_local().long()
    off = shards.block_offset(cache, 1)
    S = cache.shape[1]
    _write_rows(cache.to_local(), new, torch.where(idx < 0, idx + S, idx)
                - off)
    return cache


# ---------------------------------------------------------------------------
# DeepSeek MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_weight_shapes(*, d_model: int, num_heads: int, kv_lora_rank: int,
                      qk_nope_head_dim: int, qk_rope_head_dim: int,
                      v_head_dim: int) -> dict:
    """Name -> (shape, dtype) of the MLA weights (JAX's leaf names, the
    nested ``kv_norm`` group included), in init order."""
    H, R = num_heads, kv_lora_rank
    qd = qk_nope_head_dim + qk_rope_head_dim
    bf = DEFAULT_DTYPE
    return {
        "wq": ((d_model, H * qd), bf),
        "wdkv": ((d_model, R), bf),
        "wkr": ((d_model, qk_rope_head_dim), bf),
        "kv_norm": {"scale": ((R,), torch.float32)},
        "wuk": ((R, H * qk_nope_head_dim), bf),
        "wuv": ((R, H * v_head_dim), bf),
        "wo": ((H * v_head_dim, d_model), bf),
    }


def mla_init(gen: torch.Generator, out, **dims) -> None:
    """Fill ``out`` (a tree of :func:`mla_weight_shapes`) in place: the
    six projections fan-in truncated-normal from ``gen``, in JAX's
    order, and the ``kv_norm`` scale 1."""
    for name, spec in mla_weight_shapes(**dims).items():
        if name == "kv_norm":
            out[name]["scale"].fill_(1.0)
        else:
            fan_in, fan_out = spec[0]
            dense_init(gen, fan_in, fan_out, out=out[name])


def _mla_latents(params, x, positions, *, rope_theta):
    """The compressed cache entries of ``x`` [B,T,d]: c_kv [B,T,R]
    (rms-normed) and the rotated k_rope [B,T,1,dr]."""
    c_kv = rmsnorm(params["kv_norm"], proj(x, params["wdkv"],
                                           out_dtype=x.dtype))
    k_rope = proj(x, params["wkr"], out_dtype=x.dtype)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, theta=rope_theta)
    return c_kv, k_rope


def mla_apply(params, x, *, num_heads: int, kv_lora_rank: int,
              qk_nope_head_dim: int, qk_rope_head_dim: int,
              v_head_dim: int, positions, causal: bool = True,
              rope_theta: float = 10000.0, impl: str = "blockwise",
              q_block: int = 512, kv_block: int = 1024):
    """Full-sequence MLA (naive, un-absorbed form).  Returns (y, (c_kv,
    k_rope)): the COMPRESSED cache entries, [B,T,R] and [B,T,dr]."""
    del kv_lora_rank
    B, T, _ = x.shape
    H, dn, dr, dv = num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim
    q = proj(x, params["wq"], out_dtype=x.dtype).reshape(B, T, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    c_kv, k_rope = _mla_latents(params, x, positions, rope_theta=rope_theta)
    q_rope = apply_rope(q_rope, positions, theta=rope_theta)
    k_nope = proj(c_kv, params["wuk"], out_dtype=x.dtype).reshape(B, T, H, dn)
    v = proj(c_kv, params["wuv"], out_dtype=x.dtype).reshape(B, T, H, dv)
    # One rope head for all H: a copy here (the flash kernel reads a
    # dense [B,T,H,dn+dr]), JAX's free broadcast.
    k = torch.cat([k_nope, k_rope.expand(B, T, H, dr)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    # v is padded with zeros to the qk head dim for the shared attention
    # routes, then the output is sliced back (JAX's route).
    v_p = shards.pad(v, (0, dn + dr - dv)) if dv < dn + dr else v
    o = _attend(impl, qf, k, v_p, causal=causal, q_block=q_block,
                kv_block=kv_block)
    o = o[..., :dv]
    y = proj(o.reshape(B, T, H * dv), params["wo"], out_dtype=x.dtype)
    return y, (c_kv, k_rope[:, :, 0, :])


def mla_decode_apply(params, x, cache_ckv, cache_kr, cache_len, *,
                     num_heads: int, kv_lora_rank: int,
                     qk_nope_head_dim: int, qk_rope_head_dim: int,
                     v_head_dim: int, positions,
                     rope_theta: float = 10000.0):
    """Weight-absorbed MLA decode on the compressed cache, in place.

    score_nope = (q_nope W_uk^T) · c_kv   — W_uk absorbed into the query
    out        = (attn · c_kv) W_uv       — W_uv absorbed into the output

    x: [B,1,d]; cache_ckv [B,S,R], cache_kr [B,S,dr]; cache_len i32[B]
    INCLUDING the new token.  The new rows are written as
    :func:`_scatter_token` writes K/V (a row past ``S`` is dropped).  As
    JAX's: ``q_lat`` and the ``W_uv`` product in f32, the latent-cache
    score and value dots in the cache dtype, then cast to f32.  Returns
    (y, cache_ckv, cache_kr).
    """
    B = x.shape[0]
    H, dn, dr, dv = num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim
    R = kv_lora_rank
    q = proj(x, params["wq"], out_dtype=x.dtype).reshape(B, 1, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, theta=rope_theta)[:, 0]
    wuk = params["wuk"].reshape(R, H, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                         wuk.float())                       # [B,H,R]
    c_new, kr_new = _mla_latents(params, x, positions, rope_theta=rope_theta)
    idx = cache_len - 1
    _scatter_token(cache_ckv, c_new[:, 0], idx)
    _scatter_token(cache_kr, kr_new[:, 0, 0], idx)
    scale = 1.0 / math.sqrt(dn + dr)
    s = (_cache_dot("bhr,bsr->bhs", q_lat.to(cache_ckv.dtype),
                    cache_ckv).float()
         + _cache_dot("bhd,bsd->bhs", q_rope.to(cache_kr.dtype),
                      cache_kr).float()) * scale
    S = cache_ckv.shape[1]
    valid = torch.arange(S, device=x.device)[None, :] < cache_len[:, None]
    s = torch.where(valid[:, None], s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = _cache_dot("bhs,bsr->bhr", w.to(cache_ckv.dtype),
                       cache_ckv).float()                   # [B,H,R]
    wuv = params["wuv"].reshape(R, H, dv)
    o = torch.einsum("bhr,rhd->bhd", o_lat, wuv.float())
    y = proj(o.reshape(B, H * dv).to(x.dtype), params["wo"],
             out_dtype=x.dtype)
    return y[:, None, :], cache_ckv, cache_kr
