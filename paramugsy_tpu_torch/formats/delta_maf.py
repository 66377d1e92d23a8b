"""delta -> MAF conversion (the external ``delta2maf`` role).

Every delta entry becomes one two-row MAF block; gapped texts are
reconstructed from the entry's gap ranges and the underlying sequences.
(The reference shells out to Mugsy's MUMmer-fork ``delta2maf`` binary:
lib/nucmer/mugsy_nucmer.ml:118-124, lib/base/mugsy_profiles_task.ml:59-62.)
"""
from __future__ import annotations

from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np

from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.formats.delta import DeltaEntry
from paramugsy_tpu_torch.formats.maf import MafBlock, MafSequence

_COMPLEMENT = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")

GAP = ord("-")


def _row_text(seq: str, rng: Range, gaps: Sequence[Range], length: int) -> str:
    """Gapped row text: ``seq`` characters of ``rng`` (oriented) with '-' at
    the gap columns."""
    out = np.full(length, GAP, dtype=np.uint8)
    consume = np.ones(length, dtype=bool)
    for g in gaps:
        consume[g.start - 1 : g.end] = False
    if rng.is_forward:
        chars = seq[rng.start - 1 : rng.end].encode()
    else:
        chars = seq[rng.end - 1 : rng.start].encode()[::-1].translate(_COMPLEMENT)
    src = np.frombuffer(chars, dtype=np.uint8)
    if int(consume.sum()) != len(src):
        raise ValueError(
            f"delta entry inconsistent: {int(consume.sum())} consuming columns "
            f"vs range length {len(src)}"
        )
    out[consume] = src
    return out.tobytes().decode()


def delta_to_maf_blocks(
    entries: Iterable[DeltaEntry],
    ref_seqs: Mapping[str, str],
    query_seqs: Mapping[str, str],
    score: int = 0,
) -> Iterator[MafBlock]:
    for de in entries:
        length = de.alignment_length()
        ref_seq = ref_seqs[de.ref_name]
        query_seq = query_seqs[de.query_name]
        ref_row = MafSequence(
            name=de.ref_name,
            start=de.ref_range.to_maf(de.ref_len)[0],
            size=de.ref_range.length,
            strand=de.ref_range.direction,
            src_size=de.ref_len,
            text=_row_text(ref_seq, de.ref_range, de.ref_gaps, length),
        )
        query_row = MafSequence(
            name=de.query_name,
            start=de.query_range.to_maf(de.query_len)[0],
            size=de.query_range.length,
            strand=de.query_range.direction,
            src_size=de.query_len,
            text=_row_text(query_seq, de.query_range, de.query_gaps, length),
        )
        yield MafBlock(seqs=[ref_row, query_row], score=score, attrs={"label": "1", "mult": "2"})


def _gap_ranges(text: str) -> list[Range]:
    """1-indexed alignment-column runs of '-' in a gapped row."""
    arr = np.frombuffer(text.encode(), dtype=np.uint8) == GAP
    if not arr.any():
        return []
    d = np.diff(arr.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1)
    if arr[0]:
        starts = np.concatenate([[0], starts])
    if arr[-1]:
        ends = np.concatenate([ends, [len(arr) - 1]])
    return [Range(int(s) + 1, int(e) + 1) for s, e in zip(starts, ends)]


def maf_blocks_to_deltas(blocks: Iterable[MafBlock]) -> Iterator[DeltaEntry]:
    """Inverse of `delta_to_maf_blocks`: two-row MAF blocks -> delta entries.

    Lets precomputed pairwise MAFs (the reference's -maf_list inputs,
    lib/mugsy/mugsy_mugsy.ml:107-116) feed the merge machinery, which
    consumes deltas.  Blocks are normalized so the ref row is forward
    (both rows flipped when needed); blocks with other than 2 rows are
    skipped.
    """
    for b in blocks:
        if len(b.seqs) != 2:
            continue
        r, q = b.seqs
        rr, qr = r.range(), q.range()
        r_gaps, q_gaps = _gap_ranges(r.text), _gap_ranges(q.text)
        if not rr.is_forward:
            # flip both rows so ref is forward; gap columns mirror
            L = len(r.text)
            rr, qr = rr.reverse(), qr.reverse()
            r_gaps = [Range(L - g.end + 1, L - g.start + 1) for g in reversed(r_gaps)]
            q_gaps = [Range(L - g.end + 1, L - g.start + 1) for g in reversed(q_gaps)]
        yield DeltaEntry(
            ref_name=r.name,
            query_name=q.name,
            ref_len=r.src_size,
            query_len=q.src_size,
            ref_range=rr,
            query_range=qr,
            ref_gaps=r_gaps,
            query_gaps=q_gaps,
        )
