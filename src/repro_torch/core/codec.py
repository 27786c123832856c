"""Batch-identifier codecs (paper §III-A), PyTorch port.

Counterpart of :mod:`repro.core.codec`:

* :class:`PaperCodec` — the paper's Horner scheme over Σν: base
  ``|Σ|+1``, digit 0 is ν ("no event"), real types are 1-based, and the
  ids ``1..B`` with ``B = Σ_{i=1..n}(|Σ|+1)^i`` include the redundant
  ν-containing words (§IV.C).  It serves the host schedulers.
* :class:`DenseCodec` — a bijective base-|Σ| numbering over ν-free
  words up to ``max_len``: ``id(word of length k) = offset(k) +
  Σ_i digit_i·|Σ|^i`` with ``offset(k) = Σ_{j=1..k-1}|Σ|^j``, so the ids
  are contiguous, directly usable as dispatch indices.

In both the FIRST event is the least significant digit.
``encode``/``decode`` run on the host; ``encode_torch`` is the
on-device Horner evaluation.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import torch


def geometric_sum(base: int, n: int) -> int:
    """Σ_{i=1..n} base^i  (number of non-empty words up to length n)."""
    if base == 1:
        return n
    return (base ** (n + 1) - base) // (base - 1)


def paper_batch_count(num_types: int, max_len: int) -> int:
    """B from §III-A: all words over Σν up to length n (excluding ε)."""
    return geometric_sum(num_types + 1, max_len)


def dense_batch_count(num_types: int, max_len: int) -> int:
    """ν-free word count: Σ_{i=1..n} |Σ|^i."""
    return geometric_sum(num_types, max_len)


def redundant_batch_count(num_types: int, max_len: int) -> int:
    """§IV.C: codes composed by the paper scheme that are never used."""
    return (paper_batch_count(num_types, max_len)
            - dense_batch_count(num_types, max_len))


@dataclasses.dataclass(frozen=True)
class PaperCodec:
    """Paper-faithful Horner codec over Σν (digit 0 = ν)."""

    num_types: int
    max_len: int

    @property
    def base(self) -> int:
        return self.num_types + 1

    @property
    def num_batches(self) -> int:
        return paper_batch_count(self.num_types, self.max_len)

    def encode(self, type_ids: Sequence[int]) -> int:
        """Horner scheme, the first event the least significant digit,
        so :meth:`decode` yields the handlers in execution order."""
        if not 1 <= len(type_ids) <= self.max_len:
            raise ValueError(f"batch length must be in [1, {self.max_len}]")
        code = 0
        for t in reversed(type_ids):
            if not 0 <= t < self.num_types:
                raise ValueError(f"type id {t} out of range")
            code = code * self.base + (t + 1)
        return code

    def decode(self, code: int) -> list[int]:
        """Inverse of encode; skips ν digits as GENBATCH does."""
        if code <= 0:
            raise ValueError("code must be positive (0 is the empty word)")
        out = []
        while code:
            digit = code % self.base
            if digit > 0:  # "check for ν-event"
                out.append(digit - 1)
            code //= self.base
        return out

    def enumerate_codes(self):
        """All codes ``1..B`` (paper Alg. 1 ENUMERATEBATCHES); many
        decode to the same ν-free word (the redundancy of §IV.C)."""
        return range(1, self.num_batches + 1)

    def encode_torch(self, padded_types: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
        """On-device encode: i32[max_len] types + i32 length -> i32 id,
        the unrolled Horner loop of ``repro``'s ``encode_jnp`` (lanes
        ``>= length`` are skipped)."""
        device = padded_types.device
        types = padded_types.to(torch.int32)
        length = torch.as_tensor(length, dtype=torch.int32, device=device)
        code = torch.zeros((), dtype=torch.int32, device=device)
        for pos in range(self.max_len - 1, -1, -1):
            valid = pos < length
            digit = torch.where(valid, types[pos] + 1, 0)
            code = torch.where(valid, code * self.base + digit, code)
        return code


@dataclasses.dataclass(frozen=True)
class DenseCodec:
    """Bijective, redundancy-free codec (paper §IV.D future work)."""

    num_types: int
    max_len: int

    @property
    def base(self) -> int:
        return self.num_types

    @property
    def num_batches(self) -> int:
        return dense_batch_count(self.num_types, self.max_len)

    def offset(self, length: int) -> int:
        """Start id of the length-``length`` group."""
        return geometric_sum(self.num_types, length - 1)

    def encode(self, type_ids: Sequence[int]) -> int:
        k = len(type_ids)
        if not 1 <= k <= self.max_len:
            raise ValueError(f"batch length must be in [1, {self.max_len}]")
        code = 0
        for t in reversed(type_ids):
            if not 0 <= t < self.num_types:
                raise ValueError(f"type id {t} out of range")
            code = code * self.base + t
        return self.offset(k) + code

    def decode(self, code: int) -> list[int]:
        if not 0 <= code < self.num_batches:
            raise ValueError(f"code {code} out of range")
        length = 1
        while code >= self.offset(length) + self.base ** length:
            length += 1
        rem = code - self.offset(length)
        out = []
        for _ in range(length):
            out.append(rem % self.base)
            rem //= self.base
        return out

    def enumerate_codes(self):
        return range(self.num_batches)

    def enumerate_words(self):
        """Yield (code, word) for every distinct batch, in id order."""
        for code in self.enumerate_codes():
            yield code, self.decode(code)

    def words_over(self, type_ids):
        """Yield ``(code, word)`` in id order for every ν-free word drawn
        only from ``type_ids``: the reachable compositions the static
        analyzer hands to fused dispatch.

        Within a length group the ids number the words in base |Σ| with
        the FIRST event least significant, so the product runs over the
        reversed word and restores execution order.
        """
        alphabet = sorted(set(int(t) for t in type_ids))
        for t in alphabet:
            if not 0 <= t < self.num_types:
                raise ValueError(f"type id {t} out of range")
        for k in range(1, self.max_len + 1):
            for rev in itertools.product(alphabet, repeat=k):
                word = list(reversed(rev))
                yield self.encode(word), word

    def encode_torch(self, padded_types: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
        """On-device encode: i32[max_len] types + i32 length -> i32 id.

        The same unrolled Horner loop as ``repro``'s ``encode_jnp``:
        lanes ``>= length`` are skipped and the length group's offset
        is looked up from a ``max_len + 1`` table.
        """
        device = padded_types.device
        types = padded_types.to(torch.int32)
        length = torch.as_tensor(length, dtype=torch.int32, device=device)
        code = torch.zeros((), dtype=torch.int32, device=device)
        for i in range(self.max_len - 1, -1, -1):
            code = torch.where(i < length, code * self.base + types[i], code)
        # The offset table is copied to the device once: a copy from
        # host memory cannot be captured in a CUDA graph.
        key = (self.num_types, self.max_len, device)
        offs = _OFFSETS.get(key)
        if offs is None:
            offs = _OFFSETS[key] = torch.tensor(
                [self.offset(k) if k >= 1 else 0
                 for k in range(self.max_len + 1)],
                dtype=torch.int32, device=device)
        at = length.long().reshape(1)
        return offs.index_select(0, at).reshape(()) + code


# (num_types, max_len, device) -> DenseCodec's length-group offsets.
_OFFSETS: dict = {}


def make_codec(kind: str, num_types: int, max_len: int):
    if kind == "dense":
        return DenseCodec(num_types, max_len)
    if kind == "paper":
        return PaperCodec(num_types, max_len)
    raise ValueError(f"unknown codec kind {kind!r}")
