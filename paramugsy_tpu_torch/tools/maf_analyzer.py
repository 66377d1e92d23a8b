"""Per-genome coverage analysis (the maf_analyzer role).

Maintains per-sequence sorted disjoint covered ranges with adjacency
merging and reports uncovered (missing) ranges
(lib/profiles_cpp/maf_analyzer_missing.cc:41-170 semantics).
"""
from __future__ import annotations

import os
from typing import Iterable

from paramugsy_tpu_torch.formats.maf import MafBlock, read_maf


def covered_ranges(maf_path_or_blocks) -> dict[str, list[tuple[int, int]]]:
    """seq -> merged sorted 0-indexed inclusive covered intervals."""
    blocks = (
        read_maf(maf_path_or_blocks)
        if isinstance(maf_path_or_blocks, (str, os.PathLike))
        else maf_path_or_blocks
    )
    raw: dict[str, list[tuple[int, int]]] = {}
    sizes: dict[str, int] = {}
    for b in blocks:
        for s in b.seqs:
            raw.setdefault(s.name, []).append(s.forward_interval())
            sizes[s.name] = s.src_size
    merged: dict[str, list[tuple[int, int]]] = {}
    for name, ivs in raw.items():
        ivs.sort()
        out: list[tuple[int, int]] = []
        for s, e in ivs:
            if out and s <= out[-1][1] + 1:  # overlap or adjacency -> merge
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        merged[name] = out
    merged["__sizes__"] = sizes  # type: ignore[assignment]
    return merged


def missing_ranges(maf_path_or_blocks) -> dict[str, list[tuple[int, int]]]:
    cov = covered_ranges(maf_path_or_blocks)
    sizes: dict[str, int] = cov.pop("__sizes__")  # type: ignore[assignment]
    missing: dict[str, list[tuple[int, int]]] = {}
    for name, ivs in cov.items():
        out = []
        pos = 0
        for s, e in ivs:
            if s > pos:
                out.append((pos, s - 1))
            pos = e + 1
        if pos < sizes[name]:
            out.append((pos, sizes[name] - 1))
        missing[name] = out
    return missing


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="maf_analyzer")
    ap.add_argument("maf")
    args = ap.parse_args(argv)
    miss = missing_ranges(args.maf)
    any_missing = False
    for name in sorted(miss):
        for s, e in miss[name]:
            any_missing = True
            print(f"missing\t{name}\t{s}\t{e}")
    if not any_missing:
        print("no missing ranges")
    return 0
