"""Invariant auditing for the device engines (DESIGN.md §9), PyTorch port.

Counterpart of :mod:`repro.core.validate` for every queue mode the port
runs.  Two layers, selected by ``DeviceEngine(validate=...)``:

* **cheap** — an int32 *fault word* (a bit per invariant class) that the
  engine ORs into its stats carry each super-step, from device work
  matched to the queue: O(front_cap + num_runs) for a tiered3 queue
  (:func:`tiered3_fault_bits`), O(front_cap) for a two-tier one
  (:func:`tiered_fault_bits`), O(capacity) for the flat and reference
  queues, whose extraction is O(capacity) already
  (:func:`flat_fault_bits`), and each shard plus the global
  conservation law for a sharded queue (:func:`sharded_fault_bits`).
  The engine folds ``fault_word == 0`` into the loop guard it already
  reads to the host once a super-step, so the check adds no host read,
  and a corrupted pending set stops the run at the first poisoned
  super-step.
* **full** — :func:`full_audit`, an O(capacity) audit on the host at
  segment boundaries only: for tiered3 queues duplicated seqs across
  tiers, the sortedness of every run remainder, the cross-tier boundary
  invariant and the occupancy recounted from the raw buffers; reduced
  checks for the other modes, as in JAX.

The bit layout and names are the JAX package's (``FAULT_NAMES`` is the
wire format of :class:`EngineFaultError` and ``RunResult.fault_word``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "EngineFaultError",
    "FAULT_NAMES",
    "FAULT_FRONT_ORDER",
    "FAULT_TIME_NONFINITE",
    "FAULT_SEQ_RANGE",
    "FAULT_TIER_COUNTS",
    "FAULT_CONSERVATION",
    "FAULT_CLOCK",
    "FAULT_OVERFLOW",
    "FAULT_SPILL_STALL",
    "FAULT_AUDIT",
    "FAULT_INGEST",
    "fault_names",
    "full_audit",
    "flat_fault_bits",
    "raise_on_findings",
    "rank_fault_bits",
    "sharded_fault_bits",
    "stacked_sharded_fault_bits",
    "tiered3_fault_bits",
    "tiered_fault_bits",
]

# Packed fault-word layout (int32).  Bits are sticky: once set in the
# stats carry they survive to the host.
FAULT_FRONT_ORDER = 1      # front tier not (time, seq)-sorted
FAULT_TIME_NONFINITE = 2   # NaN/inf timestamp on an occupied slot
FAULT_SEQ_RANGE = 4        # occupied seq >= next_seq (counter bound)
FAULT_TIER_COUNTS = 8      # tier counter outside its structural range
FAULT_CONSERVATION = 16    # occupancy(+dropped) != size
FAULT_CLOCK = 32           # window head precedes the committed clock
FAULT_OVERFLOW = 64        # overflow='error' tripped (dropped > 0)
FAULT_SPILL_STALL = 128    # spill held host-side but no room to absorb
FAULT_AUDIT = 256          # full cross-tier audit finding (host-side)
FAULT_INGEST = 512         # arrival stream stalled (backpressure) or
                           # rejected (backpressure='error'), host-side

FAULT_NAMES = {
    FAULT_FRONT_ORDER: "front_order",
    FAULT_TIME_NONFINITE: "time_nonfinite",
    FAULT_SEQ_RANGE: "seq_range",
    FAULT_TIER_COUNTS: "tier_counts",
    FAULT_CONSERVATION: "conservation",
    FAULT_CLOCK: "clock_regression",
    FAULT_OVERFLOW: "overflow",
    FAULT_SPILL_STALL: "spill_stall",
    FAULT_AUDIT: "full_audit",
    FAULT_INGEST: "ingest_stall",
}


def fault_names(word: int) -> list[str]:
    """Decode a fault word into its invariant names (LSB first)."""
    return [name for bit, name in sorted(FAULT_NAMES.items())
            if int(word) & bit]


class EngineFaultError(RuntimeError):
    """A run tripped an engine invariant (or the ``overflow='error'`` /
    spill / ingest policies could not proceed).  ``fault_word`` is the
    packed bit set, ``fault_step`` the super-step that first set it (-1
    when detected on the host between segments), ``faults`` the decoded
    names."""

    def __init__(self, fault_word: int, fault_step: int = -1,
                 detail: str = ""):
        self.fault_word = int(fault_word)
        self.fault_step = int(fault_step)
        self.faults = fault_names(fault_word)
        where = (f" at super-step {self.fault_step}"
                 if self.fault_step >= 0 else "")
        msg = (f"engine invariant violated{where}: "
               f"{', '.join(self.faults) or hex(self.fault_word)}")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


# ---------------------------------------------------------------------------
# Cheap per-super-step checks (device work, an int32 0-d fault word)
# ---------------------------------------------------------------------------

def _bit(pred, bit: int) -> torch.Tensor:
    return torch.where(pred, bit, 0).to(torch.int32)


def tiered3_fault_bits(q, *, local: bool) -> torch.Tensor:
    """Cheap fault word for one tiered3 queue, O(front_cap + num_runs).
    ``local=True`` applies the occupancy discipline of spill-mode queues
    (``size`` == real occupancy); ``local=False`` the single-queue rule
    (``size`` counts ghosts: occupancy + dropped == size).

    As in JAX, the front checks reduce with one max over per-slot words
    (when different slots break different invariants in one super-step
    only the larger bit is named), and a run whose offsets are
    structurally invalid poisons the occupancy sum, so it surfaces as
    ``conservation``; :func:`full_audit` names both exactly."""
    F, S = q.front_cap, q.stage_cap
    t, s = q.f_times, q.f_seqs
    i = torch.arange(F - 1, dtype=torch.int32, device=t.device)
    occ_i = i < q.front_n
    pair_occ = (i + 1) < q.front_n
    t0, t1 = t[:-1], t[1:]
    s0, s1 = s[:-1], s[1:]
    pair_ok = (t0 < t1) | ((t0 == t1) & (s0 < s1))
    word = (_bit(pair_occ & ~pair_ok, FAULT_FRONT_ORDER)
            | _bit(occ_i & ~torch.isfinite(t0), FAULT_TIME_NONFINITE)
            | _bit(occ_i & (s0 >= q.next_seq), FAULT_SEQ_RANGE))
    bits = torch.max(word) if F > 1 else torch.zeros(
        (), dtype=torch.int32, device=t.device)
    last_occ = q.front_n >= F
    bits = bits | _bit(last_occ & ~torch.isfinite(t[F - 1]),
                       FAULT_TIME_NONFINITE)
    bits = bits | _bit(last_occ & (s[F - 1] >= q.next_seq), FAULT_SEQ_RANGE)

    live = q.r_len - q.r_off
    run_bad = (q.r_off < 0) | (live < 0) | (q.r_len > S)
    occ = (q.front_n + q.stage_n + q.main_n
           + torch.sum(torch.where(run_bad, 1 << 24, live)).to(torch.int32))
    counts_ok = ((q.front_n >= 0) & (q.front_n <= F)
                 & (q.stage_n >= 0) & (q.stage_n <= S)
                 & (q.main_n >= 0) & (q.main_n <= q.main_phys))
    bits = bits | _bit(~counts_ok, FAULT_TIER_COUNTS)
    conserved = (occ == q.size) if local else (occ + q.dropped == q.size)
    return bits | _bit(~conserved, FAULT_CONSERVATION)


def _lex_sorted_bits(times, seqs, occ_n) -> torch.Tensor:
    """FRONT_ORDER bit for an occupied-prefix layout: every adjacent
    occupied pair ascends under ``(time, seq)`` (a NaN fails every
    compare, so a poisoned slot trips it too)."""
    i = torch.arange(times.shape[0] - 1, dtype=torch.int32,
                     device=times.device)
    pair_occ = (i + 1) < occ_n
    t0, t1 = times[:-1], times[1:]
    s0, s1 = seqs[:-1], seqs[1:]
    ok = (t0 < t1) | ((t0 == t1) & (s0 < s1))
    return _bit(torch.any(pair_occ & ~ok), FAULT_FRONT_ORDER)


def _occupied_slot_bits(times, seqs, occ_mask, next_seq) -> torch.Tensor:
    return (_bit(torch.any(occ_mask & ~torch.isfinite(times)),
                 FAULT_TIME_NONFINITE)
            | _bit(torch.any(occ_mask & (seqs >= next_seq)),
                   FAULT_SEQ_RANGE))


def tiered_fault_bits(q) -> torch.Tensor:
    """Cheap fault word for a two-tier queue, O(front_cap)."""
    F, S = q.front_cap, q.stage_cap
    occ_f = torch.arange(F, dtype=torch.int32,
                         device=q.f_times.device) < q.front_n
    bits = (_lex_sorted_bits(q.f_times, q.f_seqs, q.front_n)
            | _occupied_slot_bits(q.f_times, q.f_seqs, occ_f, q.next_seq))
    counts_ok = ((q.front_n >= 0) & (q.front_n <= F)
                 & (q.stage_n >= 0) & (q.stage_n <= S)
                 & (q.main_n >= 0) & (q.main_n <= q.m_times.shape[0]))
    occ = q.front_n + q.stage_n + q.main_n
    return (bits | _bit(~counts_ok, FAULT_TIER_COUNTS)
            | _bit(occ + q.dropped != q.size, FAULT_CONSERVATION))


def flat_fault_bits(q, *, sorted_layout: bool) -> torch.Tensor:
    """Cheap fault word for a flat queue, O(capacity) like its
    extraction.  ``sorted_layout=False`` (the reference queue, whose
    slot placement is legitimately unsorted) skips the order and
    prefix checks."""
    occ = q.types >= 0
    n_occ = torch.sum(occ).to(torch.int32)
    bits = torch.zeros((), dtype=torch.int32, device=occ.device)
    if sorted_layout:
        prefix_ok = ~torch.any(occ & (torch.cumsum((~occ).to(torch.int32),
                                                   0) > 0))
        bits = (bits | _lex_sorted_bits(q.times, q.seqs, n_occ)
                | _bit(~prefix_ok, FAULT_TIER_COUNTS))
    return (bits | _occupied_slot_bits(q.times, q.seqs, occ, q.next_seq)
            | _bit(n_occ + q.dropped != q.size, FAULT_CONSERVATION))


def rank_fault_bits(shards, size, dropped, group=None) -> torch.Tensor:
    """The sharded fault word from the per-shard queues ``shards`` held
    here: each shard's word under the local discipline and its
    occupancy, then, with a process ``group``, ONE gather of every
    rank's (a collective), ORed, and the global law ``sum of
    occupancies + dropped == size`` over the replicated counters.  Every
    rank of ``group`` computes the same word (JAX's fold, ``shard_map``
    path, ``:815-832``)."""
    from repro_torch.core.queue import all_gather_rows, tiered3_queue_occupancy

    rows = torch.stack([torch.stack([tiered3_fault_bits(q, local=True),
                                     tiered3_queue_occupancy(q)])
                        for q in shards])
    if group is not None:
        rows = all_gather_rows(rows, group)
    bits = rows[0, 0]
    for word in rows[1:, 0]:
        bits = bits | word
    total_occ = torch.sum(rows[:, 1]).to(torch.int32)
    return bits | _bit(total_occ + dropped != size, FAULT_CONSERVATION)


def stacked_sharded_fault_bits(sq) -> torch.Tensor:
    """Cheap fault word for a :class:`~repro_torch.core.sharded.
    StackedShardedQueue`: the same audit as :func:`sharded_fault_bits`,
    folded per rank (:func:`rank_fault_bits`).  A placed queue's rank
    holds one shard and gathers the others' words, a collective that
    every rank calls; an unplaced one holds them all."""
    from repro_torch.core.queue import _stacked_shard, to_local

    q = sq.q._make(to_local(x) for x in sq.q)
    group = (sq.q.f_times.device_mesh.get_group("shards") if sq.placed
             else None)
    return rank_fault_bits(
        [_stacked_shard(q, i) for i in range(q.f_times.shape[0])],
        to_local(sq.size), to_local(sq.dropped), group)


def sharded_fault_bits(sq) -> torch.Tensor:
    """Cheap fault word for a sharded queue: each shard under the local
    discipline (``size`` == its real occupancy), plus the global law
    ``sum of occupancies + dropped == size``."""
    return rank_fault_bits(sq.shards, sq.size, sq.dropped)


# ---------------------------------------------------------------------------
# Full cross-tier audit (host-side, segment boundaries only)
# ---------------------------------------------------------------------------

def _audit_columns(findings, label, times, seqs, *, expect_sorted):
    if times.size == 0:
        return
    if not np.all(np.isfinite(times)):
        findings.append((FAULT_TIME_NONFINITE,
                         f"{label}: non-finite timestamp"))
    if expect_sorted and times.size > 1:
        t0, t1 = times[:-1], times[1:]
        s0, s1 = seqs[:-1], seqs[1:]
        if not np.all((t0 < t1) | ((t0 == t1) & (s0 < s1))):
            findings.append((FAULT_FRONT_ORDER,
                             f"{label}: not (time, seq)-sorted"))


def _live_regions(a: dict, num_runs: int):
    """(label, times, seqs, expect_sorted) per live tier region."""
    head, main_n = int(a["m_head"]), int(a["main_n"])
    fn, sn = int(a["front_n"]), int(a["stage_n"])
    regions = [
        ("front", a["f_times"][:fn], a["f_seqs"][:fn], True),
        ("staging", a["s_times"][:sn], a["s_seqs"][:sn], False),
        ("main", a["m_times"][head:head + main_n],
         a["m_seqs"][head:head + main_n], True),
    ]
    for i in range(num_runs):
        lo, hi = a["r_off"][i], a["r_len"][i]
        regions.append((f"run[{i}]", a["r_times"][i, lo:hi],
                        a["r_seqs"][i, lo:hi], True))
    return regions


def _audit_tiered3(a: dict, num_runs: int, F: int, S: int, findings, *,
                   local: bool) -> int:
    """The tiered3 audit of one queue's arrays into ``findings``;
    returns the occupancy its live regions hold."""
    fn, sn = int(a["front_n"]), int(a["stage_n"])
    off, rlen = a["r_off"], a["r_len"]
    regions = _live_regions(a, num_runs)
    occ = sum(r[1].size for r in regions)
    if not (0 <= fn <= F and 0 <= sn <= S and 0 <= int(a["main_n"])
            and np.all((off >= 0) & (off <= rlen) & (rlen <= S))):
        findings.append((FAULT_TIER_COUNTS,
                         "tier counter outside structural range"))
        return occ  # the checks below would read ill-defined slices
    for label, times, seqs, expect_sorted in regions:
        _audit_columns(findings, label, times, seqs,
                       expect_sorted=expect_sorted)
    all_seqs = np.concatenate([r[2] for r in regions])
    if all_seqs.size and np.unique(all_seqs).size != all_seqs.size:
        findings.append((FAULT_SEQ_RANGE, "duplicated seq across tiers"))
    if all_seqs.size and int(all_seqs.max()) >= int(a["next_seq"]):
        findings.append((FAULT_SEQ_RANGE,
                         "queued seq >= next_seq counter"))
    # Cross-tier boundary invariant: max(front) <= min(everything else)
    # under the lexicographic key.
    front = regions[0]
    rest_t = np.concatenate([r[1] for r in regions[1:]])
    rest_s = np.concatenate([r[2] for r in regions[1:]])
    if fn and rest_t.size:
        fmax = (float(front[1][-1]), int(front[2][-1]))
        j = np.lexsort((rest_s, rest_t))[0]
        rmin = (rest_t[j], rest_s[j])
        if fmax > rmin:
            findings.append((FAULT_FRONT_ORDER,
                             f"tier boundary inverted: front max {fmax} "
                             f"> rest min {rmin}"))
    size, dropped = int(a["size"]), int(a["dropped"])
    expect = size if local else size - dropped
    if occ != expect:
        findings.append((FAULT_CONSERVATION,
                         f"occupancy {occ} != expected {expect} "
                         f"(size {size}, dropped {dropped})"))
    return occ


def full_audit(queue, *, local: bool = False) -> list[tuple[int, str]]:
    """O(capacity) audit of a pending set on the host; returns findings
    as ``(fault_bit, message)``.  Takes a tiered3 queue, a sharded queue
    (each shard under the local discipline, then the global law; a
    placed one is gathered, a collective), or a two-tier or flat queue
    (JAX's reduced checks).  Call at segment boundaries only."""
    from repro_torch.core.queue import queue_to_arrays

    findings: list[tuple[int, str]] = []
    if hasattr(queue, "gathered"):
        # A placed stacked queue: every rank gathers the whole of it.
        queue = queue.gathered()
    if hasattr(queue, "shards"):
        total_occ = 0
        for i, q in enumerate(queue.shards):
            shard_findings: list[tuple[int, str]] = []
            total_occ += _audit_tiered3(
                queue_to_arrays(q), q.num_runs, q.front_cap, q.stage_cap,
                shard_findings, local=True)
            findings.extend((bit, f"shard {i}: {msg}")
                            for bit, msg in shard_findings)
        size, dropped = int(queue.size), int(queue.dropped)
        if total_occ + dropped != size:
            findings.append((
                FAULT_CONSERVATION,
                f"global occupancy {total_occ} + dropped {dropped} != "
                f"size {size}"))
        return findings
    a = queue_to_arrays(queue)
    if "r_times" in a:
        _audit_tiered3(a, queue.num_runs, queue.front_cap, queue.stage_cap,
                       findings, local=local)
        return findings
    if "f_times" in a:  # two-tier
        fn = int(a["front_n"])
        _audit_columns(findings, "front", a["f_times"][:fn],
                       a["f_seqs"][:fn], expect_sorted=True)
        occ = fn + int(a["stage_n"]) + int(a["main_n"])
        if occ + int(a["dropped"]) != int(a["size"]):
            findings.append((FAULT_CONSERVATION,
                             f"occupancy {occ} + dropped != size"))
        return findings
    # flat / reference
    occ_mask = a["types"] >= 0
    times, seqs = a["times"][occ_mask], a["seqs"][occ_mask]
    if times.size and not np.all(np.isfinite(times)):
        findings.append((FAULT_TIME_NONFINITE,
                         "flat: non-finite timestamp"))
    if seqs.size and np.unique(seqs).size != seqs.size:
        findings.append((FAULT_SEQ_RANGE, "flat: duplicated seq"))
    if int(occ_mask.sum()) + int(a["dropped"]) != int(a["size"]):
        findings.append((FAULT_CONSERVATION,
                         "flat: occupancy + dropped != size"))
    return findings


def raise_on_findings(findings, *, step: int = -1):
    """Collapse :func:`full_audit` findings into one typed error."""
    if not findings:
        return
    word = FAULT_AUDIT
    for bit, _ in findings:
        word |= bit
    detail = "; ".join(msg for _, msg in findings)
    raise EngineFaultError(word, step, detail)
