"""FASTA reading/writing and paramugsy-style header normalization.

The orchestrator rewrites every input FASTA so each record is named
``species.accession`` where ``species`` comes from the file's basename (up to
the first '.').  Rules reproduced from the reference
(lib/base/m_rewrite_fasta.ml:5-66):

* ``>gi|x|y|ACC.N|z``  ->  ``>species.ACC``        (NCBI form, version dropped)
* ``>species:header``  ->  ``>species.header``     (explicit species form)
* any other header     ->  ``>species.cleaned``    ('-', '.', ' ' -> '_')

and the species name itself has '-' replaced by '_'.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, TextIO


def read_fasta(path_or_file) -> Iterator[tuple[str, str]]:
    """Yield (header_without_gt, sequence) for each record."""
    close = False
    if isinstance(path_or_file, (str, os.PathLike)):
        fin: TextIO = open(path_or_file)
        close = True
    else:
        fin = path_or_file
    try:
        header = None
        chunks: list[str] = []
        for line in fin:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:]
                chunks = []
            else:
                chunks.append(line)
        if header is not None:
            yield header, "".join(chunks)
    finally:
        if close:
            fin.close()


def write_fasta(fout: TextIO, records: Iterable[tuple[str, str]], width: int = 80) -> None:
    for name, seq in records:
        fout.write(f">{name}\n")
        if width <= 0:
            fout.write(seq + "\n")
        else:
            for i in range(0, len(seq), width):
                fout.write(seq[i : i + width] + "\n")


def species_of_path(path: str) -> str:
    """Species name from file basename, up to first '.', '-' -> '_'."""
    base = os.path.basename(path)
    species = base.split(".", 1)[0]
    return species.replace("-", "_")


def normalize_header(header: str, species: str) -> str:
    """Rewrite one FASTA header into ``species.accession`` form."""
    if header.startswith("gi|"):
        parts = header.split("|")
        if len(parts) == 5:
            name = parts[3].split(".", 1)[0]
            return f"{species}.{name}"
        raise ValueError(f"Unknown NCBI header: >{header}")
    if ":" in header:
        sp, rest = header.split(":", 1)
        rest = rest.split(":", 1)[0] if ":" in rest else rest
        return f"{sp}.{rest}"
    cleaned = header.replace("-", "_").replace(".", "_").replace(" ", "_")
    return f"{species}.{cleaned}"


def rewrite_fasta(in_path: str, out_path: str, width: int = 0) -> list[str]:
    """Normalize all headers of ``in_path`` into ``out_path``.

    Returns the list of new record names.  (reference:
    lib/base/paramugsy.ml:206-216 writes the rewritten genomes into tmp_dir.)
    """
    species = species_of_path(in_path)
    names: list[str] = []
    with open(out_path, "w") as fout:
        for header, seq in read_fasta(in_path):
            name = normalize_header(header, species)
            names.append(name)
            write_fasta(fout, [(name, seq)], width=width)
    return names
