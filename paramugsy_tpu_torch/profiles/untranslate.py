"""Untranslate: map a MAF over pseudo-sequences back to genome coordinates.

The inverse of make+translate: after the next level aligns the blocks'
consensus pseudo-sequences, each ``s`` line over a pseudo-sequence is expanded
back into one ``s`` line per underlying profile row, in original genome
coordinates, with reverse-complementing when the walk direction flips.

Semantics reproduce lib/profiles/m_untranslate.ml:38-123 exactly:

* the s-line's range on the pseudo-sequence IS a profile-index range;
* each overlapping profile row is subset to that range (rows that are all
  gaps there are skipped);
* the output text keeps the s-line's gap structure and substitutes the
  row's (possibly reversed + complemented) characters for the non-gaps;
* MAF start/size arithmetic follows get_real_range/get_start_size.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np

from paramugsy_tpu_torch.coords.profile import Profile
from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.formats.maf import MafBlock, MafSequence, read_maf

_COMPLEMENT = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def revcomp(text: str) -> str:
    return text[::-1].translate(_COMPLEMENT)


def complement(text: str) -> str:
    return text.translate(_COMPLEMENT)


def expand_text(row_text: str, template: str) -> str:
    """Substitute row characters into the template's non-gap positions.

    reference: lib/profiles/m_untranslate.ml:38-52
    """
    out = np.frombuffer(template.encode(), dtype=np.uint8).copy()
    nz = out != ord("-")
    src = np.frombuffer(row_text.encode(), dtype=np.uint8)
    n = int(nz.sum())
    if n != len(src):
        raise ValueError(
            f"expand_text: template has {n} non-gap chars but row has {len(src)}"
        )
    out[nz] = src
    return out.tobytes().decode()


def untranslate_row(p: Profile, overlap: Range, template: str) -> MafSequence | None:
    """Expand one profile row for one pseudo-sequence s line; None if all-gap."""
    sub = p.subset_profile(overlap.start, overlap.end)
    if sub is None:
        return None
    # Orientation of the emitted row (m_untranslate.ml:55-69).
    if overlap.is_forward:
        real_range, direction = sub.range, p.range.direction
    else:
        real_range = sub.range.reverse()
        direction = p.range.reverse().direction
    # Branch on `direction`, NOT real_range.is_forward: a 1-bp interval
    # collapses to "forward" in the direction-carrying Range (start ==
    # end), and the forward arithmetic would mirror its MAF start to
    # src_size+1-x (found as paired Gap/Overlap coverage faults).
    from paramugsy_tpu_torch.coords.range import FORWARD

    if direction == FORWARD:
        start, size = real_range.start - 1, real_range.length
    else:
        start, size = p.src_size - real_range.start, real_range.length

    seq_text = sub.text if p.range.direction == direction else sub.reverse().text
    maf_text = expand_text(seq_text, template)
    if p.range.direction != direction:
        maf_text = complement(maf_text)
    return MafSequence(
        name=p.seq_name,
        start=start,
        size=size,
        strand=direction,
        src_size=p.src_size,
        text=maf_text,
    )


def untranslate_blocks(
    profile_sets: Iterable[Profile], blocks: Iterable[MafBlock]
) -> Iterator[MafBlock]:
    """Expand every block over pseudo-sequences into genome-coordinate rows."""
    by_major: dict[str, list[Profile]] = {}
    for p in profile_sets:
        by_major.setdefault(p.major_name, []).append(p)

    for block in blocks:
        out_seqs: list[MafSequence] = []
        for s in block.seqs:
            rows = by_major.get(s.name)
            if rows is None:
                # Sequence not from a known profile set: pass through.
                out_seqs.append(s)
                continue
            overlap = Range.of_maf(s.start, s.size, s.src_size, s.strand)
            for p in rows:
                row = untranslate_row(p, overlap, s.text)
                if row is not None:
                    out_seqs.append(row)
        if out_seqs:
            yield MafBlock(seqs=out_seqs, score=block.score, attrs=block.attrs)


def untranslate(
    profile_dirs: Sequence[str], in_maf, lite: bool = False
) -> Iterator[MafBlock]:
    """File-level driver: reference m_untranslate.ml:165-177."""
    from paramugsy_tpu_torch.coords.profile import read_profile_set
    import os

    profiles: list[Profile] = []
    for d in profile_dirs:
        profiles.extend(read_profile_set(os.path.join(d, "profiles"), lite=lite))
    yield from untranslate_blocks(profiles, read_maf(in_maf))
