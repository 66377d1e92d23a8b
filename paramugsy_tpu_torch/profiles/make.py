"""MAF -> profile set ("mugsy_profiles make").

Streams a MAF; every block becomes (a) one profile per ``s`` row, written to
``<out_dir>/profiles``, and (b) one consensus pseudo-sequence in
``<out_dir>/sequences.fasta`` named ``<basename>.<basename>_<block#>``.
Consensus rule: equal chars kept; disagreement -> ``N``; a gap in one row is
filled from the other (reference: lib/profiles/m_make.ml:15-28, naming:
lib/profiles/m_profile_stream.ml:60-68).

The pseudo-sequences are the "genomes" of the next alignment level; their
coordinates are the blocks' profile (column) indices.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from paramugsy_tpu_torch.coords.profile import Profile
from paramugsy_tpu_torch.formats.maf import MafBlock, read_maf

GAP = ord("-")


def profiles_of_block(block: MafBlock, major_name: str) -> list[Profile]:
    return [
        Profile.of_maf_entry(
            name=(major_name, str(i)),
            seq_name=s.name,
            range=s.range(),
            src_size=s.src_size,
            text=s.text,
        )
        for i, s in enumerate(block.seqs)
    ]


def consensus_text(texts: list[str]) -> str:
    """Column-wise consensus of equal-length gapped texts (vectorized)."""
    if not texts:
        return ""
    mat = np.frombuffer("".join(texts).encode(), dtype=np.uint8).reshape(
        len(texts), -1
    )
    out = mat[0].copy()
    for row in mat[1:]:
        both = (out != GAP) & (row != GAP)
        disagree = both & (out != row)
        out = np.where(out == GAP, row, out)
        out[disagree] = ord("N")
    return out.tobytes().decode()


def profile_stream_of_maf(in_maf, basename: str) -> Iterator[list[Profile]]:
    """Yield the profile rows of each MAF block, named like the reference."""
    for i, block in enumerate(read_maf(in_maf)):
        major = f"{basename}.{basename}_{i:04d}"
        yield profiles_of_block(block, major)


def profile_set_of_maf(in_maf, out_dir: str, basename: str) -> list[str]:
    """Write ``profiles`` + ``sequences.fasta`` for a MAF.

    Returns the list of pseudo-sequence (major) names.
    """
    os.makedirs(out_dir, exist_ok=True)
    majors: list[str] = []
    with open(os.path.join(out_dir, "profiles"), "w") as pf, open(
        os.path.join(out_dir, "sequences.fasta"), "w"
    ) as ff:
        for rows in profile_stream_of_maf(in_maf, basename):
            for p in rows:
                p.write(pf)
            major = rows[0].major_name
            majors.append(major)
            ff.write(f">{major}\n{consensus_text([p.text for p in rows])}\n\n")
    return majors
