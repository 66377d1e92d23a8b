"""Delta translation into profile coordinates — the heart of tree merging.

Given a pairwise alignment (delta entry) between two *genome* sequences and a
pair of profiles — a row of the left alignment block over the ref sequence and
a row of the right block over the query sequence — rewrite the alignment into
the coordinate spaces of the two blocks' pseudo-sequences (profile/column
indices).  The output is a stream of delta entries between pseudo-sequences,
which the next alignment level treats as ordinary genomes.

Role and conventions follow the reference's production C++
(lib/m_translate/m_translate.cc): same inputs (two profile-set dirs + nucmer
delta list), same output framing (delta entries named by the blocks' major
names with header lengths = profile lengths, ref range always forward, query
range reversed when the right profile is walked backwards).

The algorithm is redesigned for array hardware: instead of the reference's
iterative 7-case gap-walk state machine with gap splitting and pushback
(m_translate.cc:279-472), we materialize the overlap window *column space*
and compute everything with vectorized index maps:

1. Reverse the delta if its ref direction differs from the left profile's
   (m_translate.cc:210-217 semantics).
2. Map the seq-space overlaps into delta column space; intersect to get the
   shared window (m_translate.cc:474-513 semantics).
3. For every column: which side consumes a base (delta gap masks), which
   profile position it lands on (vectorized binary-search index maps).
4. Entry *splits* are profile-index jumps > 1 between consecutive consuming
   columns (a gap in the left/right profile row).
5. Each segment is trimmed to start/end on match columns and emitted with
   gap runs read straight off the masks.

One deliberate divergence: when a delta gap abuts a profile gap exactly, the
reference may attribute the delta-gap columns to the adjacent entry as
leading/trailing one-sided gap columns; we trim entries to match columns, so
such orphan columns (aligned to nothing) are dropped.  The matched-pair
content of the output is identical.
"""
from __future__ import annotations

import os
from bisect import bisect_left
from typing import Iterable, Iterator, Sequence, TextIO

import numpy as np

from paramugsy_tpu_torch.coords.profile import Profile, read_profile_set
from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.formats.delta import DeltaEntry, DeltaWriter, read_delta


def _mask_of_gaps(gaps: Sequence[Range], w0: int, L: int) -> np.ndarray:
    """Boolean mask over columns [w0, w0+L) marking gap positions."""
    m = np.zeros(L, dtype=bool)
    for g in gaps:
        a = max(g.start, w0) - w0
        b = min(g.end, w0 + L - 1) - w0
        if a <= b:
            m[a : b + 1] = True
    return m


def _runs(mask: np.ndarray) -> list[Range]:
    """1-indexed runs of True values."""
    if not mask.any():
        return []
    d = np.diff(mask.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if mask[0]:
        starts = np.concatenate(([0], starts))
    if mask[-1]:
        ends = np.concatenate((ends, [len(mask)]))
    return [Range(int(s) + 1, int(e)) for s, e in zip(starts, ends)]


def translate_entry(de: DeltaEntry, lp: Profile, rp: Profile) -> list[DeltaEntry]:
    """Translate one delta entry through one (left, right) profile pair."""
    ref_ov = de.ref_range.overlap(lp.range)
    query_ov = de.query_range.overlap(rp.range)
    if ref_ov is None or query_ov is None:
        return []

    # Walk the delta in the left profile's direction.
    de2 = de.reverse() if de.ref_range.direction != lp.range.direction else de

    d_ref = de2.ref_profile()
    d_query = de2.query_profile()

    d_ref_range = Range(
        d_ref.profile_idx_of_seq_idx(ref_ov.start),
        d_ref.profile_idx_of_seq_idx(ref_ov.end),
    )
    d_query_range = Range(
        d_query.profile_idx_of_seq_idx(query_ov.start),
        d_query.profile_idx_of_seq_idx(query_ov.end),
    )
    d_ov = d_ref_range.overlap(d_query_range)
    if d_ov is None:
        return []

    w0, L = d_ov.start, d_ov.length
    cols = np.arange(w0, w0 + L, dtype=np.int64)

    ref_gap = _mask_of_gaps(de2.ref_gaps, w0, L)
    query_gap = _mask_of_gaps(de2.query_gaps, w0, L)

    # Sequence positions consumed at each column, mapped into profile space.
    ok_r, ref_seq = d_ref.seq_idx_of_profile_idx_v(cols)
    ok_q, query_seq = d_query.seq_idx_of_profile_idx_v(cols)
    # The delta's own gap masks and the per-column maps must agree.
    # (ok_r == ~ref_gap by construction.)

    lp_idx = np.zeros(L, dtype=np.int64)
    lp_idx[ok_r] = lp.profile_idx_of_seq_idx_v(ref_seq[ok_r])

    reversed_mp = rp.range.direction != de2.query_range.direction
    rp_raw = rp.profile_idx_of_seq_idx_v(query_seq[ok_q])
    rp_meta = np.zeros(L, dtype=np.int64)
    rp_meta[ok_q] = (rp.length - rp_raw + 1) if reversed_mp else rp_raw

    # Splits: profile-index jumps between consecutive consuming columns.
    breaks = np.zeros(L, dtype=bool)
    ridx = np.flatnonzero(ok_r)
    if len(ridx) > 1:
        jump = (lp_idx[ridx[1:]] - lp_idx[ridx[:-1]]) > 1
        breaks[ridx[1:][jump]] = True
    qidx = np.flatnonzero(ok_q)
    if len(qidx) > 1:
        jump = (rp_meta[qidx[1:]] - rp_meta[qidx[:-1]]) > 1
        breaks[qidx[1:][jump]] = True

    match = ok_r & ok_q
    bounds = [0] + [int(i) for i in np.flatnonzero(breaks)] + [L]

    def meta_back(m: int) -> int:
        return rp.length - m + 1 if reversed_mp else m

    out: list[DeltaEntry] = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        mcols = np.flatnonzero(match[s:e])
        if len(mcols) == 0:
            continue
        a, b = s + int(mcols[0]), s + int(mcols[-1])  # trimmed, inclusive
        seg_ref_gap = ref_gap[a : b + 1]
        seg_query_gap = query_gap[a : b + 1]
        out.append(
            DeltaEntry(
                ref_name=lp.major_name,
                query_name=rp.major_name,
                ref_len=lp.length,
                query_len=rp.length,
                ref_range=Range(int(lp_idx[a]), int(lp_idx[b])),
                query_range=Range(meta_back(int(rp_meta[a])), meta_back(int(rp_meta[b]))),
                ref_gaps=_runs(seg_ref_gap),
                query_gaps=_runs(seg_query_gap),
            )
        )
    return out


class _ProfileIndex:
    """Per-sequence sorted profile lists with binary-search candidate lookup.

    reference: m_translate.cc:188-207 (sort) and :682-695 (lower_bound).
    """

    def __init__(self, profiles: Iterable[Profile]):
        self.by_seq: dict[str, list[Profile]] = {}
        for p in profiles:
            self.by_seq.setdefault(p.seq_name, []).append(p)
        self._starts: dict[str, list[int]] = {}
        for name, ps in self.by_seq.items():
            ps.sort(key=lambda p: p.range.abs().start)
            self._starts[name] = [p.range.abs().start for p in ps]

    def overlapping(self, seq_name: str, r: Range) -> list[Profile]:
        ps = self.by_seq.get(seq_name)
        if not ps:
            return []
        ra = r.abs()
        hi = bisect_left(self._starts[seq_name], ra.end + 1)
        return [p for p in ps[:hi] if p.range.abs().end >= ra.start]


def translate_deltas(
    left_profiles: Iterable[Profile],
    right_profiles: Iterable[Profile],
    deltas: Iterable[DeltaEntry],
) -> Iterator[DeltaEntry]:
    """Translate a delta stream through left/right profile sets."""
    left = _ProfileIndex(left_profiles)
    right = _ProfileIndex(right_profiles)
    for de in deltas:
        for lp in left.overlapping(de.ref_name, de.ref_range):
            for rp in right.overlapping(de.query_name, de.query_range):
                yield from translate_entry(de, lp, rp)


def translate(
    left_dir: str,
    right_dir: str,
    nucmer_list: Sequence[str],
    out_stream: TextIO,
    legacy_errors: bool = True,
) -> int:
    """File-level driver matching the reference CLI contract.

    reference: m_translate.cc:713-729 — reads ``<dir>/profiles`` from both
    sides, streams each delta file, writes one merged delta stream.
    Returns the number of entries written.
    """
    from paramugsy_tpu_torch.profiles.native_translate import translate_deltas_fast

    left = read_profile_set(os.path.join(left_dir, "profiles"), lite=True)
    right = read_profile_set(os.path.join(right_dir, "profiles"), lite=True)
    writer = DeltaWriter(out_stream, left_dir, right_dir, legacy_errors=legacy_errors)
    n = 0

    def delta_stream() -> Iterator[DeltaEntry]:
        for path in nucmer_list:
            yield from read_delta(path)

    for entry in translate_deltas_fast(left, right, delta_stream()):
        writer.write(entry)
        n += 1
    return n
