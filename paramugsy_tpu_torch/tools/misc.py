"""Small stream filters: mafclean, fastafmt, sort_delta.

* mafclean  — parse + re-emit a MAF (drops comments, normalizes whitespace;
  lib/mafclean/main.ml:3-15).
* fastafmt  — re-wrap FASTA sequence lines to width N
  (lib/fastafmt/main.ml:22-28).
* sort_delta — canonical delta ordering: by header names then ranges, for
  deterministic/mergeable output (lib/profiles_cpp/m_sort_delta.cc:58-94).
"""
from __future__ import annotations

import sys

from paramugsy_tpu_torch.formats.delta import DeltaWriter, read_delta
from paramugsy_tpu_torch.formats.fasta import read_fasta, write_fasta
from paramugsy_tpu_torch.formats.maf import read_maf, write_maf


def mafclean_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="mafclean")
    ap.add_argument("in_maf")
    ap.add_argument("out_maf", nargs="?")
    args = ap.parse_args(argv)
    blocks = list(read_maf(args.in_maf))
    if args.out_maf:
        write_maf(args.out_maf, blocks)
    else:
        write_maf(sys.stdout, blocks)
    return 0


def fastafmt_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="fastafmt")
    ap.add_argument("in_fasta")
    ap.add_argument("-width", type=int, default=80)
    args = ap.parse_args(argv)
    write_fasta(sys.stdout, read_fasta(args.in_fasta), width=args.width)
    return 0


def sort_delta_entries(entries):
    return sorted(
        entries,
        key=lambda e: (
            e.ref_name,
            e.query_name,
            e.ref_range.start,
            e.ref_range.end,
            e.query_range.start,
            e.query_range.end,
        ),
    )


def sort_delta_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="sort_delta")
    ap.add_argument("in_delta")
    ap.add_argument("out_delta", nargs="?")
    args = ap.parse_args(argv)
    entries = sort_delta_entries(read_delta(args.in_delta))
    out = open(args.out_delta, "w") if args.out_delta else sys.stdout
    try:
        w = DeltaWriter(out)
        for e in entries:
            w.write(e)
    finally:
        if args.out_delta:
            out.close()
    return 0
