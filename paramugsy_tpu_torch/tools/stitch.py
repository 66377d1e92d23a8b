"""MAF de-fragmentation / stitching.

Completes what the reference left unfinished: ``mafdefrag`` never invoked
its chainer or wrote output (lib/mafdefrag/main.ml:80,94-98) and
``maf_stitch.cc``'s core branch is empty (maf_stitch.cc:47-69).  The intent
is documented at maf_stitch.cc:117-128: *group alignment ids whose entries
are adjacent across all genomes into one stitched alignment*.

Adjacency: two blocks with identical (seq name, strand) row sets where, for
every row, the successor's strand-local MAF start equals the predecessor's
start + size.  Chains of adjacent blocks are merged by concatenating texts.
"""
from __future__ import annotations

import os
from typing import Iterable

from paramugsy_tpu_torch.formats.maf import MafBlock, MafSequence, read_maf, write_maf


def _end_key(b: MafBlock) -> tuple:
    return tuple(
        sorted((s.name, s.strand, s.start + s.size) for s in b.seqs)
    )


def _start_key(b: MafBlock) -> tuple:
    return tuple(sorted((s.name, s.strand, s.start) for s in b.seqs))


def stitch_blocks(blocks: Iterable[MafBlock]) -> list[MafBlock]:
    blocks = list(blocks)
    by_start: dict[tuple, int] = {}
    for i, b in enumerate(blocks):
        key = _start_key(b)
        # Duplicate start keys cannot be stitched unambiguously; keep first.
        by_start.setdefault(key, i)

    successor: dict[int, int] = {}
    has_pred: set[int] = set()
    for i, b in enumerate(blocks):
        j = by_start.get(_end_key(b))
        if j is not None and j != i and j not in has_pred:
            successor[i] = j
            has_pred.add(j)

    out: list[MafBlock] = []
    for i, b in enumerate(blocks):
        if i in has_pred:
            continue
        # head of a chain: merge the run
        chain = [i]
        j = i
        while j in successor:
            j = successor[j]
            chain.append(j)
        if len(chain) == 1:
            out.append(b)
            continue
        rows: dict[tuple[str, int], MafSequence] = {
            (s.name, s.strand): MafSequence(
                s.name, s.start, s.size, s.strand, s.src_size, s.text
            )
            for s in b.seqs
        }
        for j in chain[1:]:
            for s in blocks[j].seqs:
                r = rows[(s.name, s.strand)]
                r.size += s.size
                r.text += s.text
        merged = MafBlock(
            seqs=[rows[(s.name, s.strand)] for s in b.seqs],
            score=b.score,
            attrs=dict(b.attrs),
        )
        merged.attrs["mult"] = str(len(merged.seqs))
        out.append(merged)
    return out


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="mafdefrag")
    ap.add_argument("in_maf")
    ap.add_argument("out_maf")
    ap.add_argument(
        "-synchain",
        help="also write the adjacent-anchor edge file for an external "
        "chainer (the reference's synchain input, mafdefrag/main.ml:3-61)",
    )
    ap.add_argument(
        "-chained",
        help="verify an external chainer's output file (I/V format) "
        "against contiguity before stitching; exit 1 on faults",
    )
    args = ap.parse_args(argv)
    in_blocks = list(read_maf(args.in_maf))
    if args.synchain:
        from paramugsy_tpu_torch.tools.synchain import write_synchain

        with open(args.synchain, "w") as f:
            write_synchain(in_blocks, f)
    if args.chained:
        from paramugsy_tpu_torch.tools.synchain import read_chained, verify_chains

        with open(args.chained) as f:
            chains = read_chained(f)
        faults = verify_chains(chains)
        if faults:
            for acc, a, b in faults:
                print(
                    f"chain fault: accession {acc} "
                    f"{a.start}-{a.end} !~ {b.start}-{b.end}"
                )
            return 1
    blocks = stitch_blocks(in_blocks)
    write_maf(args.out_maf, blocks)
    print(f"stitched into {len(blocks)} blocks")
    return 0
