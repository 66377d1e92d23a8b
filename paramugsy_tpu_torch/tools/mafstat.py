"""MAF statistics (the mafstat plugin suite: P_core + P_missing).

Core-genome counting follows lib/mafstat/p_core.ml:12-89: collapse each
block's rows into a gap mask, count columns with no gap anywhere; a block
contributes to the core when every genome is present.  One deliberate fix:
the reference skips blocks that contain *no* gaps at all (p_core.ml:41-47
only records when num_gaps > 0) — a fully gapless all-genome block is pure
core, so we count it.

Missing/unique counting follows lib/mafstat/p_missing.ml: per genome,
aligned bp (blocks with >= 2 genomes), unique bp (single-genome blocks),
and totals from src sizes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from paramugsy_tpu_torch.formats.maf import read_maf


def genome_of(name: str) -> str:
    return name.split(".", 1)[0]


@dataclass
class MafStats:
    num_genomes: int = 0
    core_bp: int = 0
    shortest_genome: int = 0
    aligned_bp: dict = field(default_factory=dict)  # genome -> bp in multi blocks
    unique_bp: dict = field(default_factory=dict)  # genome -> bp in single blocks
    totals: dict = field(default_factory=dict)  # genome -> total length
    # Alignment quality: sum-of-pairs identity over multi-row blocks
    # (agreeing base pairs / compared base pairs, gaps excluded).
    sp_pairs_compared: int = 0
    sp_pairs_agree: int = 0

    @property
    def sp_identity(self) -> float:
        return self.sp_pairs_agree / self.sp_pairs_compared if self.sp_pairs_compared else 0.0


def compute_stats(maf_path_or_blocks) -> MafStats:
    blocks = (
        read_maf(maf_path_or_blocks)
        if isinstance(maf_path_or_blocks, (str, os.PathLike))
        else maf_path_or_blocks
    )
    st = MafStats()
    seq_sizes: dict[str, int] = {}
    core_cols: list[tuple[int, int]] = []  # (#genomes, no-gap bp)
    all_genomes: set[str] = set()
    for b in blocks:
        genomes_here = {genome_of(s.name) for s in b.seqs}
        all_genomes |= genomes_here
        for s in b.seqs:
            seq_sizes[s.name] = s.src_size
            g = genome_of(s.name)
            if len(genomes_here) > 1:
                st.aligned_bp[g] = st.aligned_bp.get(g, 0) + s.size
            else:
                st.unique_bp[g] = st.unique_bp.get(g, 0) + s.size
        mat = np.frombuffer(
            "".join(s.text for s in b.seqs).encode(), dtype=np.uint8
        ).reshape(len(b.seqs), -1)
        no_gap = (mat != ord("-")).all(axis=0).sum()
        core_cols.append((len(genomes_here), int(no_gap)))
        if len(b.seqs) > 1:
            present = mat != ord("-")
            for i in range(len(b.seqs)):
                for j in range(i + 1, len(b.seqs)):
                    both = present[i] & present[j]
                    st.sp_pairs_compared += int(both.sum())
                    st.sp_pairs_agree += int((both & (mat[i] == mat[j])).sum())

    st.num_genomes = len(all_genomes)
    st.core_bp = sum(bp for n, bp in core_cols if n == st.num_genomes)
    for name, size in seq_sizes.items():
        g = genome_of(name)
        st.totals[g] = st.totals.get(g, 0) + size
    st.shortest_genome = min(st.totals.values()) if st.totals else 0
    return st


def write_stats(st: MafStats, out_dir: str) -> None:
    """Write the reference's ``core_genome`` and ``missing`` files."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "core_genome"), "w") as f:
        f.write(f"num_genomes\t{st.num_genomes}\n")
        f.write(f"core\t{st.core_bp}\n")
        f.write(f"shortest_genome_len\t{st.shortest_genome}\n")
        f.write(f"sp_identity\t{st.sp_identity:.4f}\n")
    with open(os.path.join(out_dir, "missing"), "w") as f:
        f.write("genome\taligned\tunique\ttotal\tmissing\n")
        for g in sorted(st.totals):
            aligned = st.aligned_bp.get(g, 0)
            unique = st.unique_bp.get(g, 0)
            total = st.totals[g]
            f.write(
                f"{g}\t{aligned}\t{unique}\t{total}\t{total - aligned - unique}\n"
            )


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="mafstat")
    ap.add_argument("maf")
    ap.add_argument("-out_dir", default=".")
    args = ap.parse_args(argv)
    st = compute_stats(args.maf)
    write_stats(st, args.out_dir)
    print(f"num_genomes={st.num_genomes} core={st.core_bp}")
    return 0
