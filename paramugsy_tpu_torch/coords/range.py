"""Direction-carrying genomic ranges.

A range is a 1-indexed, inclusive interval on a sequence.  ``start > end``
encodes the reverse strand.  Semantics match the reference implementation
(``lib/profiles/m_range.ml``, ``lib/profiles_lib/m_range.hh``) exactly,
including the MAF conversion rules:

* forward:  MAF (start0, size) -> (start0 + 1, start0 + size)
* reverse:  MAF start counts from the 3' end of the + strand, so
  (start0, size, src_size) -> (src_size - start0, src_size - start0 - size + 1)

(reference: lib/profiles/m_range.ml:60-66)

Scalar ``Range`` objects are used in streaming/host code; batch operations on
coordinate tensors use the ``*_v`` vectorized functions over NumPy arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

FORWARD = 1
REVERSE = -1


class Range(NamedTuple):
    start: int
    end: int

    # -- direction ---------------------------------------------------------
    @property
    def direction(self) -> int:
        return FORWARD if self.start <= self.end else REVERSE

    @property
    def is_forward(self) -> bool:
        return self.start <= self.end

    def reverse(self) -> "Range":
        return Range(self.end, self.start)

    def abs(self) -> "Range":
        """Forward-orientation copy (min, max)."""
        if self.start <= self.end:
            return self
        return Range(self.end, self.start)

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return abs(self.start - self.end) + 1

    @property
    def length(self) -> int:
        return abs(self.start - self.end) + 1

    def contains(self, v: int) -> bool:
        s, e = (self.start, self.end) if self.start <= self.end else (self.end, self.start)
        return s <= v <= e

    def overlap(self, other: "Range") -> Optional["Range"]:
        """Overlapping region of the two ranges (forward orientation), or None.

        reference: lib/profiles/m_range.ml:23-30
        """
        s1, e1 = min(self.start, self.end), max(self.start, self.end)
        s2, e2 = min(other.start, other.end), max(other.start, other.end)
        s, e = max(s1, s2), min(e1, e2)
        if e - s >= 0:
            return Range(s, e)
        return None

    # -- MAF conversions ---------------------------------------------------
    @classmethod
    def of_maf(cls, start: int, size: int, src_size: int, direction: int) -> "Range":
        """0-indexed MAF (start, size, strand) -> direction-carrying range."""
        if direction == FORWARD:
            return cls(start + 1, start + size)
        return cls(src_size - start, src_size - start - (size - 1))

    def to_maf(self, src_size: int) -> tuple[int, int]:
        """Inverse of ``of_maf``: (maf_start0, size) for this range's strand.

        Forward:  start0 = start - 1.  Reverse: start0 = src_size - start
        (reference untranslate arithmetic: lib/profiles/m_untranslate.ml:62-69).
        """
        if self.is_forward:
            return self.start - 1, self.length
        return src_size - self.start, self.length


# ---------------------------------------------------------------------------
# Vectorized forms: ranges as (starts, ends) int arrays.
# ---------------------------------------------------------------------------

def overlap_v(s1, e1, s2, e2):
    """Batch overlap: returns (valid_mask, ov_start, ov_end), forward-oriented."""
    lo1, hi1 = np.minimum(s1, e1), np.maximum(s1, e1)
    lo2, hi2 = np.minimum(s2, e2), np.maximum(s2, e2)
    s = np.maximum(lo1, lo2)
    e = np.minimum(hi1, hi2)
    return e >= s, s, e


def of_maf_v(start, size, src_size, is_forward):
    """Batch MAF->range conversion. Returns (range_start, range_end)."""
    fs, fe = start + 1, start + size
    rs, re = src_size - start, src_size - start - (size - 1)
    return np.where(is_forward, fs, rs), np.where(is_forward, fe, re)


def length_v(s, e):
    return np.abs(s - e) + 1
