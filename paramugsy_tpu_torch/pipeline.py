"""Genome loading (counterpart of the start of paramugsy_tpu.pipeline).

`Genome` and `load_genome` are copied from the reference, whose module
imports JAX through its aligner.  The multi-genome pipeline is not ported
yet (ROADMAP queue A, item 7).
"""
from __future__ import annotations

from dataclasses import dataclass

from paramugsy_tpu.formats.fasta import normalize_header, read_fasta, species_of_path


@dataclass
class Genome:
    name: str  # species
    seqs: dict[str, str]  # normalized record name -> sequence

    @property
    def total_length(self) -> int:
        return sum(len(s) for s in self.seqs.values())


def load_genome(path: str) -> Genome:
    species = species_of_path(path)
    seqs: dict[str, str] = {}
    for header, seq in read_fasta(path):
        seqs[normalize_header(header, species)] = seq.upper()
    return Genome(name=species, seqs=seqs)
