"""Synchain edge-file / chained-file formats of the mafdefrag pipeline.

The reference's mafdefrag (lib/mafdefrag/main.ml:100-125) writes a
per-accession adjacent-anchor edge file for an external chainer
(lib/mafdefrag/main.ml:3-61), parses the chainer's "I ... ;"/"V" output
(lib/mafdefrag/synchain.ml:9-59), and verifies that chains tile
contiguously (lib/mafdefrag/synchain_verifier.ml:42-66) — but never
invokes the chainer nor writes the result (stubs at main.ml:80,94-98).
Here all stages work: the edge writer and chained reader/verifier are
format-compatible, and the default chainer is the internal
all-genome-adjacency stitcher (tools/stitch.py).

Known reference defect NOT copied: its ``dist`` column is always 0
(``s2 - s2``, main.ml:33-37); we emit the actual inter-anchor distance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence, TextIO

from paramugsy_tpu_torch.formats.maf import MafBlock


def _interner():
    table: dict[str, int] = {}

    def intern(s: str) -> int:
        return table.setdefault(s, len(table))

    return table, intern


def write_synchain(blocks: Sequence[MafBlock], fout: TextIO) -> None:
    """Write the synchain input: per accession, sorted adjacent anchor
    pairs, 11 space-separated columns per edge (lib/mafdefrag/main.ml:3-61):

        idxl idxr seqidx dist genomeidx s1_dir s2_dir s1_start s1_end s2_start s2_end

    Anchor index = MAF block index; genome = accession up to the first '.'.
    """
    _, intern_acc = _interner()
    _, intern_gen = _interner()
    per_acc: dict[str, list[tuple[int, int, int, str]]] = {}
    for i, b in enumerate(blocks):
        for s in b.seqs:
            fs, fe = s.forward_interval()
            per_acc.setdefault(s.name, []).append((fs, fe, i, s.strand_char))
    for acc in sorted(per_acc):
        genome = acc.split(".", 1)[0]
        seqidx = intern_acc(acc)
        genomeidx = intern_gen(genome)
        anchors = sorted(per_acc[acc])
        for (s1s, s1e, idxl, d1), (s2s, s2e, idxr, d2) in zip(
            anchors, anchors[1:]
        ):
            dist = s2s - s1e  # actual gap (+1 = contiguous)
            fout.write(
                f"{idxl} {idxr} {seqidx} {dist} {genomeidx} "
                f"{d1} {d2} {s1s} {s1e} {s2s} {s2e}\n"
            )


@dataclass
class ChainSeq:
    accession_idx: int
    start: int  # inclusive, forward strand
    end: int  # inclusive
    forward: bool


def read_chained(fin: Iterable[str]) -> list[list[ChainSeq]]:
    """Parse chainer output: ``I <seq> <dir> <start-stop> ... ;`` lines
    (stop exclusive, as in lib/mafdefrag/synchain.ml:16-31); ``V`` score
    lines are skipped."""
    chains: list[list[ChainSeq]] = []
    for line in fin:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "V":
            continue
        if parts[0] != "I":
            raise ValueError(f"bad chain line: {line.rstrip()}")
        body, seqs = parts[1:], []
        if body and body[-1] == ";":
            body = body[:-1]
        if len(body) % 3 != 0:
            raise ValueError(f"bad chain line: {line.rstrip()}")
        for i in range(0, len(body), 3):
            seq, d, rng = body[i : i + 3]
            start_s, stop_s = rng.split("-", 1)
            start, stop = int(start_s), int(stop_s)
            if start >= stop:
                raise ValueError(f"bad chain range: {rng}")
            if d not in "+-":
                raise ValueError(f"bad chain direction: {d}")
            seqs.append(ChainSeq(int(seq), start, stop - 1, d == "+"))
        chains.append(seqs)
    return chains


def verify_chains(
    chains: list[list[ChainSeq]],
) -> list[tuple[int, ChainSeq, ChainSeq]]:
    """Per accession, consecutive chained ranges must tile contiguously
    (start2 - end1 == 1); returns the violating adjacent pairs
    (lib/mafdefrag/synchain_verifier.ml:42-66)."""
    per_acc: dict[int, list[ChainSeq]] = {}
    for chain in chains:
        for cs in chain:
            per_acc.setdefault(cs.accession_idx, []).append(cs)
    faults: list[tuple[int, ChainSeq, ChainSeq]] = []
    for acc, seqs in per_acc.items():
        seqs.sort(key=lambda c: (c.start, c.end))
        for a, b in zip(seqs, seqs[1:]):
            if b.start - a.end != 1:
                faults.append((acc, a, b))
    return faults
