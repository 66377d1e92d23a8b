"""Fill uncovered MAF regions with real sequence (the maffiller role).

Finds per-sequence uncovered ranges (via the mafvalidate interval walk) and
emits single-row blocks carrying the actual FASTA sequence — the part the
reference stubbed out (lib/maffiller/main.ml:38-46 prints headers only).
Overlap faults are rejected, as in the reference (main.ml:11-29).
"""
from __future__ import annotations

from typing import Iterable, Mapping

from paramugsy_tpu_torch.coords.range import FORWARD
from paramugsy_tpu_torch.formats.fasta import read_fasta
from paramugsy_tpu_torch.formats.maf import MafBlock, MafSequence, read_maf, write_maf
from paramugsy_tpu_torch.tools.mafvalidate import find_faults


def fill_blocks(
    blocks: Iterable[MafBlock], seqs: Mapping[str, str]
) -> list[MafBlock]:
    blocks = list(blocks)
    faults = find_faults(blocks, check_ends=True)
    overlaps = [f for f in faults if f.kind == "Overlap"]
    if overlaps:
        raise ValueError(f"cannot fill a MAF with overlaps: {overlaps[:3]}")
    out = list(blocks)
    for f in faults:
        if f.seq not in seqs:
            raise KeyError(f"no FASTA sequence for {f.seq}")
        text = seqs[f.seq][f.start : f.end + 1]
        out.append(
            MafBlock(
                seqs=[
                    MafSequence(
                        name=f.seq,
                        start=f.start,
                        size=f.end - f.start + 1,
                        strand=FORWARD,
                        src_size=len(seqs[f.seq]),
                        text=text,
                    )
                ],
                score=0,
                attrs={"label": "1", "mult": "1"},
            )
        )
    return out


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="maffiller")
    ap.add_argument("in_maf")
    ap.add_argument("fasta", nargs="+")
    ap.add_argument("-out_maf", required=True)
    args = ap.parse_args(argv)
    seqs: dict[str, str] = {}
    for path in args.fasta:
        for name, seq in read_fasta(path):
            seqs[name] = seq
    blocks = fill_blocks(read_maf(args.in_maf), seqs)
    write_maf(args.out_maf, blocks)
    return 0
