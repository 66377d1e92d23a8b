"""MAF coverage validator (the mafvalidate role).

Per genome sequence, collect every row's forward-strand interval, sort, and
report faults between consecutive intervals: ``Gap`` (uncovered bases) or
``Overlap`` (bases covered twice), plus uncovered sequence ends.  Exit code
1 when any fault exists (lib/mafvalidate/main.ml:3-42,
lib/maf/missing_seqs.ml:66-96 semantics).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from paramugsy_tpu_torch.formats.maf import read_maf


@dataclass
class Fault:
    seq: str
    kind: str  # "Gap" | "Overlap"
    start: int  # 0-indexed forward
    end: int

    def __str__(self) -> str:
        return f"{self.kind}\t{self.seq}\t{self.start}\t{self.end}"


def find_faults(maf_path_or_blocks, check_ends: bool = True) -> list[Fault]:
    blocks = (
        read_maf(maf_path_or_blocks)
        if isinstance(maf_path_or_blocks, (str, os.PathLike))
        else maf_path_or_blocks
    )
    intervals: dict[str, list[tuple[int, int]]] = {}
    sizes: dict[str, int] = {}
    for b in blocks:
        if b.attrs.get("label", "").startswith("dup"):
            continue  # duplication blocks overlap the 1-1 tiling by nature
        for s in b.seqs:
            fs, fe = s.forward_interval()
            intervals.setdefault(s.name, []).append((fs, fe))
            sizes[s.name] = s.src_size
    faults: list[Fault] = []
    for name, ivs in intervals.items():
        ivs.sort()
        pos = 0
        for s, e in ivs:
            if s > pos:
                faults.append(Fault(name, "Gap", pos, s - 1))
            elif s < pos:
                faults.append(Fault(name, "Overlap", s, min(pos - 1, e)))
            pos = max(pos, e + 1)
        if check_ends and pos < sizes[name]:
            faults.append(Fault(name, "Gap", pos, sizes[name] - 1))
    return faults


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="mafvalidate")
    ap.add_argument("maf")
    ap.add_argument("--no-ends", action="store_true", help="skip end-coverage checks")
    args = ap.parse_args(argv)
    faults = find_faults(args.maf, check_ends=not args.no_ends)
    for f in faults:
        print(f)
    return 1 if faults else 0
