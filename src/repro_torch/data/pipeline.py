"""Deterministic synthetic data pipeline (PyTorch port of
:mod:`repro.data.pipeline`).

Every batch is a pure function of ``(seed, step)``: the key is
``fold_in(PRNGKey(seed), step)``, split in three, and the tokens are
inverse-CDF draws of a truncated Zipf law from the first subkey.  The
keys and the uniform draws are JAX's bit for bit
(:mod:`repro_torch.data.prng`), so a token batch is the same array in
both packages and a checkpoint of either resumes on the same data.  The
batch is made on the CPU and then moved to ``device``, so it is the
same on the CPU and on the card.

``input_mode="embeds"`` (the audio and VLM frontends' frame
embeddings) draws ``embeds`` ``[B, T, d_model]`` f32 as ``0.02 *
normal`` from the second subkey and Zipf labels from the third, as JAX's
does: the labels bit for bit, the embeddings within 3 f32 ulps of JAX's
(:func:`repro_torch.data.prng.normal`).

The power ``u ** (-1/(alpha-1))`` is taken in f64 and rounded once to
f32: XLA's f32 ``pow`` is not the one torch's CPU kernel computes, and
a token at an integer edge would differ.  The f64 power rounded to f32
gives JAX's tokens at every element the tests draw.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.data import prng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    input_mode: str = "tokens"   # tokens | embeds
    d_model: int = 0             # for embeds mode
    zipf_alpha: float = 1.1


def _zipf_tokens(key, shape, vocab, alpha):
    """Inverse-CDF sampling of a truncated Zipf over [0, vocab)."""
    u = prng.uniform(key, shape, minval=1e-6, maxval=1.0)
    # rank ~ u^{-1/(alpha-1)} heavy tail, clipped to vocab; the exponent
    # is rounded to f32 first, as JAX's weakly typed scalar is.
    expo = torch.tensor(-1.0 / (alpha - 1.0), dtype=torch.float32).double()
    ranks = torch.clamp((u.double() ** expo).float(), 1.0, float(vocab))
    return (ranks - 1.0).to(torch.int32)


def make_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """Global batch for ``step`` on ``device`` (the CPU by default):
    ``{"tokens", "labels"}`` int32 ``[global_batch, seq_len]``, the
    labels the tokens (the causal LM shifts internally); or, with
    ``input_mode="embeds"``, ``{"embeds"}`` f32 ``[global_batch,
    seq_len, d_model]`` and Zipf ``{"labels"}``."""
    key = prng.fold_in(prng.prng_key(cfg.seed), step)
    k_tok, k_emb, k_lab = prng.split(key, 3)
    shape = (cfg.global_batch, cfg.seq_len)
    if cfg.input_mode == "embeds":
        batch = {
            "embeds": prng.normal(k_emb, shape + (cfg.d_model,)) * 0.02,
            "labels": _zipf_tokens(k_lab, shape, cfg.vocab_size,
                                   cfg.zipf_alpha)}
    else:
        tokens = _zipf_tokens(k_tok, shape, cfg.vocab_size, cfg.zipf_alpha)
        batch = {"tokens": tokens, "labels": tokens}
    if device is not None:
        batch = {k: v.to(device) for k, v in batch.items()}
        if "tokens" in batch:
            batch["labels"] = batch["tokens"]
    return batch


def shard_slice(cfg: DataConfig, step: int, shard: int, num_shards: int,
                device=None) -> dict:
    """The per-DP-shard slice of the global batch, generated locally."""
    if cfg.global_batch % num_shards:
        raise ValueError("global_batch must divide by DP shards")
    per = cfg.global_batch // num_shards
    full = make_batch(cfg, step, device)
    return {k: v[shard * per:(shard + 1) * per] for k, v in full.items()}
