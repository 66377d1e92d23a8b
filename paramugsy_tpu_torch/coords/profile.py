"""Profiles: named gapped intervals of a sequence.

A *profile* represents one row (``s`` line) of a MAF block: a
direction-carrying range of a source sequence plus the gap structure of the
aligned text.  Profile indices are 1-indexed positions in the *gapped* text;
sequence indices are 1-indexed positions on the source sequence.

Semantics reproduce the reference implementation exactly — the production C++
(`lib/profiles_lib/m_profile.{hh,cc}`) backed by the OCaml model
(`lib/profiles/m_profile.ml`) — including two documented quirks downstream
code depends on:

* ``subset_profile`` returns gaps **in the parent profile's coordinates**,
  not rebased to the subset (lib/profiles/m_profile.ml:184-188).
* The subset's ``length`` is ``range.length + sum(gap lengths)`` computed
  from those un-rebased gaps (lib/profiles_lib/m_profile.hh:45-63).

Index maps are O(log n) via binary search over precomputed cumulative gap
lengths instead of the reference's linked-list walks; batch (vectorized)
variants map whole index arrays at once for the device pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, TextIO

import numpy as np

from paramugsy_tpu_torch.coords.range import FORWARD, REVERSE, Range


class SeqIdxOutOfRange(Exception):
    pass


class ProfileIdxOutOfRange(Exception):
    pass


def gaps_of_text(text: str) -> list[Range]:
    """Extract 1-indexed gap runs from '-' characters of gapped text.

    reference: lib/profiles/m_profile.ml:29-47
    """
    gaps: list[Range] = []
    arr = np.frombuffer(text.encode(), dtype=np.uint8)
    is_gap = arr == ord("-")
    if not is_gap.any():
        return gaps
    # Run-length boundaries of gap stretches.
    d = np.diff(is_gap.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if is_gap[0]:
        starts = np.concatenate(([0], starts))
    if is_gap[-1]:
        ends = np.concatenate((ends, [len(arr)]))
    for s, e in zip(starts, ends):
        gaps.append(Range(int(s) + 1, int(e)))
    return gaps


@dataclass
class Profile:
    name: tuple[str, str]  # (major, minor)
    seq_name: str
    range: Range
    length: int
    gaps: list[Range]  # ascending, in profile-index space
    src_size: int
    text: str = ""

    # Lazily built search index over gaps.
    _idx: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = field(
        default=None, repr=False, compare=False
    )

    # ------------------------------------------------------------------
    @property
    def major_name(self) -> str:
        return self.name[0]

    @property
    def minor_name(self) -> str:
        return self.name[1]

    def _gap_index(self):
        """(gap_starts, gap_ends, cum_len_before) arrays for binary search."""
        if self._idx is None:
            gs = np.fromiter((g.start for g in self.gaps), dtype=np.int64, count=len(self.gaps))
            ge = np.fromiter((g.end for g in self.gaps), dtype=np.int64, count=len(self.gaps))
            lens = ge - gs + 1
            cum = np.concatenate(([0], np.cumsum(lens)))  # cum[i] = total gap len before gap i
            self._idx = (gs, ge, cum)
        return self._idx

    # ------------------------------------------------------------------
    # Index maps (1-indexed both sides).
    # ------------------------------------------------------------------
    def profile_idx_of_seq_idx(self, si: int) -> int:
        """Map a sequence index to its profile (gapped) index.

        reference: lib/profiles_lib/m_profile.cc:92-112
        """
        if not self.range.contains(si):
            raise SeqIdxOutOfRange((si, self.range))
        offset = abs(self.range.start - si) + 1
        gs, _, cum = self._gap_index()
        # Accumulate every gap g with gs[g] <= offset + (gaps consumed so far).
        # gs[k] - cum[k] is nondecreasing for disjoint ascending gaps, so the
        # walk's fixpoint is the largest k with gs[k] - cum[k] <= offset.
        k = int(np.searchsorted(gs - cum[:-1], offset, side="right"))
        return offset + int(cum[k])

    def seq_idx_of_profile_idx(self, pi: int) -> Optional[int]:
        """Map a profile index to a sequence index; None if it lands on a gap.

        reference: lib/profiles_lib/m_profile.cc:114-149
        """
        if pi >= self.length + 1:
            raise ProfileIdxOutOfRange((pi, self.length))
        gs, ge, cum = self._gap_index()
        k = int(np.searchsorted(ge, pi))  # gaps entirely before pi
        if k < len(gs) and gs[k] <= pi:
            return None  # pi falls inside gap k
        offset = pi - int(cum[k]) - 1
        if self.range.is_forward:
            return self.range.start + offset
        return self.range.start - offset

    # Batch variants -----------------------------------------------------
    def profile_idx_of_seq_idx_v(self, si: np.ndarray) -> np.ndarray:
        offset = np.abs(self.range.start - si) + 1
        gs, _, cum = self._gap_index()
        k = np.searchsorted(gs - cum[:-1], offset, side="right")
        return offset + cum[k]

    def seq_idx_of_profile_idx_v(self, pi: np.ndarray):
        """Returns (valid_mask, seq_idx); invalid where pi is in a gap."""
        gs, ge, cum = self._gap_index()
        k = np.searchsorted(ge, pi)
        in_gap = (k < len(gs)) & (gs[np.minimum(k, max(len(gs) - 1, 0))] <= pi) if len(gs) else np.zeros(pi.shape, bool)
        offset = pi - cum[k] - 1
        si = self.range.start + offset if self.range.is_forward else self.range.start - offset
        return ~in_gap, si

    # ------------------------------------------------------------------
    # Subsets / reversal.
    # ------------------------------------------------------------------
    def subset_profile(self, s: int, e: int) -> Optional["Profile"]:
        """Subset by profile-index range [s, e] (order-insensitive).

        Returns None when the whole range is a single gap.  The returned
        profile keeps gaps in *this* profile's coordinates and has
        ``length = new_range.length + sum(gap lengths)`` — both quirks
        required by translate/untranslate.

        reference: lib/profiles_lib/m_profile.cc:160-206
        """
        if s <= 0 or s > self.length or e <= 0 or e > self.length:
            raise ProfileIdxOutOfRange(((s, e), self.length))
        if s > e:
            s, e = e, s
        # Text covers the *requested* window; the range below skips edge gaps.
        text = self.text[s - 1 : e] if self.text else ""
        sub_range = Range(s, e)
        gaps = [ov for g in self.gaps if (ov := g.overlap(sub_range)) is not None]
        if gaps:
            if len(gaps) == 1 and gaps[0].start == s and gaps[0].end == e:
                return None
            if gaps[0].start == s:
                s = gaps[0].end + 1
            if gaps[-1].end == e:
                e = gaps[-1].start - 1
        seq_s = self.seq_idx_of_profile_idx(s)
        seq_e = self.seq_idx_of_profile_idx(e)
        if seq_s is None or seq_e is None:
            return None
        new_range = Range(seq_s, seq_e)
        length = new_range.length + sum(g.length for g in gaps)
        return Profile(
            name=self.name,
            seq_name=self.seq_name,
            range=new_range,
            length=length,
            gaps=gaps,
            src_size=self.src_size,
            text=text,
        )

    def subset_seq(self, s: int, e: int) -> "Profile":
        sub = self.subset_profile(
            self.profile_idx_of_seq_idx(s), self.profile_idx_of_seq_idx(e)
        )
        if sub is None:
            raise ValueError("subset_seq landed on an all-gap region")
        return sub

    def reverse(self) -> "Profile":
        """Flip orientation; gaps mirror through the profile length.

        reference: lib/profiles/m_profile.ml:246-264
        """
        rgaps = [
            Range(self.length - g.end + 1, self.length - g.start + 1)
            for g in reversed(self.gaps)
        ]
        return Profile(
            name=self.name,
            seq_name=self.seq_name,
            range=self.range.reverse(),
            length=self.length,
            gaps=rgaps,
            src_size=self.src_size,
            text=self.text[::-1],
        )

    # ------------------------------------------------------------------
    # Construction / IO.
    # ------------------------------------------------------------------
    @classmethod
    def of_maf_entry(
        cls, name: tuple[str, str], seq_name: str, range: Range, src_size: int, text: str
    ) -> "Profile":
        return cls(
            name=name,
            seq_name=seq_name,
            range=range,
            length=len(text),
            gaps=gaps_of_text(text),
            src_size=src_size,
            text=text,
        )

    def write(self, fout: TextIO) -> None:
        """Profile-file record (reference: lib/profiles/m_profile.ml:124-137)."""
        fout.write(
            f"{self.name[0]} {self.name[1]} {self.seq_name} "
            f"{self.range.start} {self.range.end} {self.length} {self.src_size}\n"
        )
        for g in self.gaps:
            fout.write(f"{g.start} {g.end}\n")
        fout.write("0\n")
        fout.write(f"{self.text}\n")

    @classmethod
    def read(cls, fin: TextIO, lite: bool = False) -> Optional["Profile"]:
        """Read one profile record; None at EOF.

        reference: lib/profiles/m_profile.ml:69-122
        """
        header = fin.readline()
        if not header:
            return None
        parts = header.split()
        if len(parts) != 7:
            raise ValueError(f"bad profile header: {header!r}")
        major, minor, seq_name, s, e, length, src_size = parts
        gaps: list[Range] = []
        while True:
            line = fin.readline()
            if not line:
                raise ValueError("early EOF in profile gaps")
            line = line.strip()
            if line == "0":
                break
            gs, ge = line.split()
            gaps.append(Range(int(gs), int(ge)))
        text_line = fin.readline()
        text = "" if lite else text_line.strip()
        return cls(
            name=(major, minor),
            seq_name=seq_name,
            range=Range(int(s), int(e)),
            length=int(length),
            gaps=gaps,
            src_size=int(src_size),
            text=text,
        )


def read_profile_set(path: str, lite: bool = False) -> list[Profile]:
    """Read every profile record from a ``profiles`` index file."""
    out: list[Profile] = []
    with open(path) as fin:
        while (p := Profile.read(fin, lite=lite)) is not None:
            out.append(p)
    return out


class Metaprofile:
    """Lazily reversed view over a profile.

    Callers can always *add* positions while walking; reversal is applied at
    index-mapping time.  reference: lib/profiles_lib/m_metaprofile.hh:7-47
    """

    def __init__(self, profile: Profile, reversed: bool = False):
        self.profile = profile
        self.reversed = reversed

    def reverse(self) -> "Metaprofile":
        return Metaprofile(self.profile, not self.reversed)

    def profile_idx_of_profile_idx(self, pi: int) -> int:
        if not self.reversed:
            return pi
        return self.profile.length - pi + 1

    def seq_idx_of_profile_idx(self, pi: int) -> Optional[int]:
        return self.profile.seq_idx_of_profile_idx(self.profile_idx_of_profile_idx(pi))

    def profile_idx_of_seq_idx(self, si: int) -> int:
        return self.profile_idx_of_profile_idx(self.profile.profile_idx_of_seq_idx(si))
