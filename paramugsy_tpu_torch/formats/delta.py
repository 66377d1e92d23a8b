"""MUMmer ``.delta`` format: parse / serialize / reverse.

File layout (reference parser: lib/profiles/m_delta.ml:52-150):

    <ref_path> <query_path>
    NUCMER
    ><ref_seq> <query_seq> <ref_len> <query_len>
    <r_start> <r_end> <q_start> <q_end> <e1> <e2> <e3>
    <offset>...      (signed gap offsets, one per line)
    0
    ... more alignments / headers ...

Internally a gap offset run is converted to *gap ranges*: 1-indexed positions
in the gapped-alignment coordinate space where the ref (negative offsets) or
query (positive offsets) row has a gap character
(lib/profiles/m_delta.ml:17-50).  ``offsets_of_gaps`` is the exact inverse
(lib/profiles_lib/m_delta_stream_writer.hh:14-54).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator, Optional, TextIO

from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.coords.profile import Profile


@dataclass
class DeltaEntry:
    ref_name: str
    query_name: str
    ref_len: int
    query_len: int
    ref_range: Range
    query_range: Range
    ref_gaps: list[Range]  # gapped-alignment positions where ref has '-'
    query_gaps: list[Range]
    errors: tuple[int, int, int] = (0, 0, 0)

    # ------------------------------------------------------------------
    def alignment_length(self) -> int:
        return self.ref_range.length + sum(g.length for g in self.ref_gaps)

    def ref_profile(self) -> Profile:
        """Gap structure of the ref row as an anonymous profile.

        reference: lib/profiles/m_delta.ml:155-171
        """
        length = self.alignment_length()
        return Profile(
            name=("", ""), seq_name="", range=self.ref_range,
            length=length, gaps=self.ref_gaps, src_size=length, text="",
        )

    def query_profile(self) -> Profile:
        length = self.query_range.length + sum(g.length for g in self.query_gaps)
        return Profile(
            name=("", ""), seq_name="", range=self.query_range,
            length=length, gaps=self.query_gaps, src_size=length, text="",
        )

    def reverse(self) -> "DeltaEntry":
        """Flip both rows' orientation (lib/profiles/m_delta.ml:200-209)."""
        rp = self.ref_profile().reverse()
        qp = self.query_profile().reverse()
        return DeltaEntry(
            ref_name=self.ref_name,
            query_name=self.query_name,
            ref_len=self.ref_len,
            query_len=self.query_len,
            ref_range=rp.range,
            query_range=qp.range,
            ref_gaps=rp.gaps,
            query_gaps=qp.gaps,
            errors=self.errors,
        )

    def swapped(self) -> "DeltaEntry":
        """Exchange ref/query roles, normalized so the ref row stays
        forward (the alignment is flipped when the old query row was
        reverse-strand)."""
        e = DeltaEntry(
            ref_name=self.query_name,
            query_name=self.ref_name,
            ref_len=self.query_len,
            query_len=self.ref_len,
            ref_range=self.query_range,
            query_range=self.ref_range,
            ref_gaps=list(self.query_gaps),
            query_gaps=list(self.ref_gaps),
            errors=self.errors,
        )
        return e if e.ref_range.is_forward else e.reverse()


def trim_entry_left(
    e: DeltaEntry, axis: str, t: int
) -> Optional[DeltaEntry]:
    """Remove the minimal prefix of alignment columns consuming exactly
    ``t`` bases on ``axis`` ('ref' or 'query').

    Used to de-overlap collinear entries before fusing (window-boundary
    stitching): the prefix ends at the column of the t-th axis-advance, so
    the trimmed entry starts right after that base.  Returns None when the
    entry has fewer than ``t + 1`` axis bases (fully consumed).  The ref
    row must be forward (the pipeline's invariant).  ``errors`` are kept
    as-is (per-column attribution is unknown), matching the fuse
    convention in lcb.merge.
    """
    assert e.ref_range.is_forward, "trim_entry_left requires a forward ref row"
    if t <= 0:
        return e
    self_gaps = e.ref_gaps if axis == "ref" else e.query_gaps
    ncols = e.alignment_length()
    # Axis length derived from the column structure (robust to entries
    # whose row ranges disagree with their gap runs).
    axis_len = ncols - sum(g.length for g in self_gaps)
    if axis_len <= t:
        return None
    # Find c = column index (1-based) of the t-th axis-advancing column.
    adv = 0
    pos = 1  # next column to scan
    c = None
    for run in list(self_gaps) + [Range(ncols + 1, ncols + 1)]:
        avail = run.start - pos  # advancing columns before this gap run
        if adv + avail >= t:
            c = pos + (t - adv) - 1
            break
        adv += avail
        pos = run.end + 1
    assert c is not None  # axis_len > t guarantees it

    def cut(runs: list[Range]) -> tuple[list[Range], int]:
        """Shift runs left by c, clipping; also count gap columns <= c."""
        out: list[Range] = []
        gapcols = 0
        for r in runs:
            if r.end <= c:
                gapcols += r.length
            elif r.start <= c:
                gapcols += c - r.start + 1
                out.append(Range(1, r.end - c))
            else:
                out.append(Range(r.start - c, r.end - c))
        return out, gapcols

    new_rg, ref_gapcols = cut(e.ref_gaps)
    new_qg, q_gapcols = cut(e.query_gaps)
    ref_adv = c - ref_gapcols
    q_adv = c - q_gapcols
    ref_range = Range(e.ref_range.start + ref_adv, e.ref_range.end)
    if e.query_range.is_forward:
        query_range = Range(e.query_range.start + q_adv, e.query_range.end)
    else:
        query_range = Range(e.query_range.start - q_adv, e.query_range.end)
    import dataclasses

    return dataclasses.replace(
        e, ref_range=ref_range, query_range=query_range,
        ref_gaps=new_rg, query_gaps=new_qg,
    )


def trim_entry_right(
    e: DeltaEntry, axis: str, t: int
) -> Optional[DeltaEntry]:
    """Remove the minimal suffix of alignment columns consuming exactly
    ``t`` bases on ``axis`` ('ref' or 'query') — the mirror of
    `trim_entry_left`, used by LCB selection to shave a claimed margin
    off an otherwise-free entry instead of dropping it whole.

    Returns None when the entry has fewer than ``t + 1`` axis bases.
    The ref row must be forward (the pipeline's invariant).
    """
    assert e.ref_range.is_forward, "trim_entry_right requires a forward ref row"
    if t <= 0:
        return e
    self_gaps = e.ref_gaps if axis == "ref" else e.query_gaps
    ncols = e.alignment_length()
    # Axis length derived from the column structure (robust to entries
    # whose row ranges disagree with their gap runs).
    axis_len = ncols - sum(g.length for g in self_gaps)
    if axis_len <= t:
        return None
    # Find c = column index (1-based) of the t-th axis-advancing column
    # counting from the right; columns [c, ncols] are removed.
    adv = 0
    pos = ncols  # next column to scan, right-to-left
    c = None
    for run in reversed([Range(0, 0)] + list(self_gaps)):
        avail = pos - run.end  # advancing columns after this gap run
        if adv + avail >= t:
            c = pos - (t - adv) + 1
            break
        adv += avail
        pos = run.start - 1
    assert c is not None  # axis_len > t guarantees it

    def cut(runs: list[Range]) -> tuple[list[Range], int]:
        """Drop/clip runs at column >= c; count removed gap columns."""
        out: list[Range] = []
        gapcols = 0
        for r in runs:
            if r.start >= c:
                gapcols += r.length
            elif r.end >= c:
                gapcols += r.end - c + 1
                out.append(Range(r.start, c - 1))
            else:
                out.append(r)
        return out, gapcols

    new_rg, ref_gapcols = cut(e.ref_gaps)
    new_qg, q_gapcols = cut(e.query_gaps)
    removed = ncols - c + 1
    ref_adv = removed - ref_gapcols
    q_adv = removed - q_gapcols
    ref_range = Range(e.ref_range.start, e.ref_range.end - ref_adv)
    if e.query_range.is_forward:
        query_range = Range(e.query_range.start, e.query_range.end - q_adv)
    else:
        query_range = Range(e.query_range.start, e.query_range.end + q_adv)
    import dataclasses

    return dataclasses.replace(
        e, ref_range=ref_range, query_range=query_range,
        ref_gaps=new_rg, query_gaps=new_qg,
    )


def gaps_of_offsets(offsets: list[int]) -> tuple[list[Range], list[Range]]:
    """Signed MUMmer offsets -> (ref_gaps, query_gaps) as position ranges."""
    ref_pos: list[int] = []
    query_pos: list[int] = []
    pos = 0
    for x in offsets:
        pos += abs(x)
        if x < 0:
            ref_pos.append(pos)
        else:
            query_pos.append(pos)

    def squeeze(positions: list[int]) -> list[Range]:
        runs: list[Range] = []
        for p in positions:
            if runs and p == runs[-1].end + 1:
                runs[-1] = Range(runs[-1].start, p)
            else:
                runs.append(Range(p, p))
        return runs

    return squeeze(ref_pos), squeeze(query_pos)


def offsets_of_gaps(ref_gaps: list[Range], query_gaps: list[Range]) -> list[int]:
    """(ref_gaps, query_gaps) -> signed offset list terminated by 0."""
    out: list[int] = []
    ri, qi = 0, 0
    pos = 0
    while ri < len(ref_gaps) or qi < len(query_gaps):
        take_ref = qi >= len(query_gaps) or (
            ri < len(ref_gaps) and ref_gaps[ri].start < query_gaps[qi].start
        )
        if take_ref:
            g = ref_gaps[ri]
            out.append(-(g.start - pos))
            out.extend([-1] * (g.length - 1))
            pos = g.end
            ri += 1
        else:
            g = query_gaps[qi]
            out.append(g.start - pos)
            out.extend([1] * (g.length - 1))
            pos = g.end
            qi += 1
    out.append(0)
    return out


def read_delta(path_or_file) -> Iterator[DeltaEntry]:
    """Stream delta entries from a .delta file."""
    close = False
    if isinstance(path_or_file, (str, os.PathLike)):
        fin: TextIO = open(path_or_file)
        close = True
    else:
        fin = path_or_file
    try:
        lines = (l.rstrip("\n") for l in fin)
        # file header: "<ref_path> <query_path>" then "NUCMER"
        try:
            first = next(lines)
        except StopIteration:
            return
        dtype = next(lines, "")
        if dtype not in ("NUCMER", "PROMER"):
            raise ValueError(f"unknown delta type: {dtype!r}")
        header: Optional[tuple[str, str, int, int]] = None
        for line in lines:
            if not line:
                continue
            if line.startswith(">"):
                parts = line[1:].split()
                if len(parts) != 4:
                    raise ValueError(f"bad delta header: {line!r}")
                header = (parts[0], parts[1], int(parts[2]), int(parts[3]))
                continue
            parts = line.split()
            if header is None or len(parts) != 7:
                raise ValueError(f"unexpected delta line: {line!r}")
            rs, re_, qs, qe, e1, e2, e3 = (int(p) for p in parts)
            offsets: list[int] = []
            for gl in lines:
                v = int(gl)
                if v == 0:
                    break
                offsets.append(v)
            ref_gaps, query_gaps = gaps_of_offsets(offsets)
            yield DeltaEntry(
                ref_name=header[0],
                query_name=header[1],
                ref_len=header[2],
                query_len=header[3],
                ref_range=Range(rs, re_),
                query_range=Range(qs, qe),
                ref_gaps=ref_gaps,
                query_gaps=query_gaps,
                errors=(e1, e2, e3),
            )
    finally:
        if close:
            fin.close()


class DeltaWriter:
    """Streaming delta writer; dedups consecutive ``>`` headers.

    reference: lib/profiles_lib/m_delta_stream_writer.hh:56-86.  The
    reference's translate writer hardcodes the error columns to ``1 2 3``;
    we preserve whatever the entry carries (default 0 0 0) unless
    ``legacy_errors`` is set.
    """

    def __init__(self, fout: TextIO, ref_path: str = "/dev/null",
                 query_path: str = "/dev/null", legacy_errors: bool = False):
        self.fout = fout
        self._header: Optional[tuple[str, str]] = None
        self.legacy_errors = legacy_errors
        fout.write(f"{ref_path} {query_path}\nNUCMER\n")

    def write(self, de: DeltaEntry) -> None:
        names = (de.ref_name, de.query_name)
        if names != self._header:
            self.fout.write(
                f">{de.ref_name} {de.query_name} {de.ref_len} {de.query_len}\n"
            )
            self._header = names
        e1, e2, e3 = (1, 2, 3) if self.legacy_errors else de.errors
        self.fout.write(
            f"{de.ref_range.start} {de.ref_range.end} "
            f"{de.query_range.start} {de.query_range.end} {e1} {e2} {e3}\n"
        )
        for off in offsets_of_gaps(de.ref_gaps, de.query_gaps):
            self.fout.write(f"{off}\n")
