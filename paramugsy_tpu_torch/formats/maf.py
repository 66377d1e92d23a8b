"""MAF (Multiple Alignment Format) model + streaming reader/writer.

Model mirrors the reference's ``lib/maf`` library: a block (``a`` line with
attributes) holds sequences (``s`` lines: name, 0-indexed start, size, strand,
src_size, gapped text).  The paramugsy pipeline emits
``##maf version=1 scoring=paramugsy`` headers and blocks like
``a score=99999 label=1 mult=4`` (see tests/highly_stitchable.maf and
lib/profiles/m_untranslate.ml:219).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, TextIO

from paramugsy_tpu_torch.coords.range import FORWARD, REVERSE, Range

MAF_HEADER = "##maf version=1 scoring=paramugsy"


@dataclass
class MafSequence:
    name: str
    start: int  # 0-indexed, strand-relative (MAF convention)
    size: int
    strand: int  # FORWARD / REVERSE
    src_size: int
    text: str

    @property
    def strand_char(self) -> str:
        return "+" if self.strand == FORWARD else "-"

    def range(self) -> Range:
        """Direction-carrying 1-indexed range on the + strand."""
        return Range.of_maf(self.start, self.size, self.src_size, self.strand)

    def forward_interval(self) -> tuple[int, int]:
        """0-indexed inclusive (s, e) on the forward strand regardless of
        direction (reference: lib/maf/sequence.ml:29-43)."""
        if self.strand == FORWARD:
            return self.start, self.start + self.size - 1
        return (
            self.src_size - 1 - (self.start + self.size - 1),
            self.src_size - 1 - self.start,
        )

    def to_line(self) -> str:
        return (
            f"s {self.name} {self.start} {self.size} "
            f"{self.strand_char} {self.src_size} {self.text}"
        )

    @classmethod
    def from_line(cls, line: str) -> "MafSequence":
        parts = line.split()
        if len(parts) != 7 or parts[0] != "s":
            raise ValueError(f"bad MAF s line: {line!r}")
        _, name, start, size, strand, src_size, text = parts
        if strand not in "+-":
            raise ValueError(f"bad strand in: {line!r}")
        return cls(
            name=name,
            start=int(start),
            size=int(size),
            strand=FORWARD if strand == "+" else REVERSE,
            src_size=int(src_size),
            text=text,
        )


@dataclass
class MafBlock:
    seqs: list[MafSequence]
    score: Optional[float] = None
    attrs: dict[str, str] = field(default_factory=dict)  # label=, mult=, ...

    def a_line(self) -> str:
        parts = ["a"]
        if self.score is not None:
            s = self.score
            parts.append(f"score={int(s) if float(s).is_integer() else s}")
        for k, v in self.attrs.items():
            parts.append(f"{k}={v}")
        return " ".join(parts)

    @classmethod
    def parse_a_line(cls, line: str) -> "MafBlock":
        score = None
        attrs: dict[str, str] = {}
        for tok in line.split()[1:]:
            if "=" not in tok:
                continue
            k, v = tok.split("=", 1)
            if k == "score":
                try:
                    score = float(v)
                except ValueError:
                    attrs[k] = v
            else:
                attrs[k] = v
        return cls(seqs=[], score=score, attrs=attrs)


def read_maf(path_or_file) -> Iterator[MafBlock]:
    """Stream blocks of a MAF file (comments and header skipped)."""
    close = False
    if isinstance(path_or_file, (str, os.PathLike)):
        fin: TextIO = open(path_or_file)
        close = True
    else:
        fin = path_or_file
    try:
        block: Optional[MafBlock] = None
        for line in fin:
            line = line.strip()
            if not line:
                if block is not None and block.seqs:
                    yield block
                block = None
                continue
            if line.startswith("#"):
                continue
            if line.startswith("a"):
                if block is not None and block.seqs:
                    yield block
                block = MafBlock.parse_a_line(line)
            elif line.startswith("s "):
                if block is None:
                    block = MafBlock(seqs=[])
                block.seqs.append(MafSequence.from_line(line))
            # other line types (q/i/e) ignored
        if block is not None and block.seqs:
            yield block
    finally:
        if close:
            fin.close()


def write_maf(path_or_file, blocks: Iterable[MafBlock], header: str = MAF_HEADER) -> None:
    close = False
    if isinstance(path_or_file, (str, os.PathLike)):
        fout: TextIO = open(path_or_file, "w")
        close = True
    else:
        fout = path_or_file
    try:
        if header:
            fout.write(header + "\n")
        for block in blocks:
            fout.write(block.a_line() + "\n")
            for s in block.seqs:
                fout.write(s.to_line() + "\n")
            fout.write("\n")
    finally:
        if close:
            fout.close()


def maf_to_xmfa(path_or_file, fout: TextIO) -> None:
    """MAF -> XMFA conversion (mugsyWGA ``--aln`` input format).

    reference: lib/profiles/m_xmfa.ml:25-56 — one ``>name start size strand
    src_size`` + text line per sequence, blocks terminated by ``=``.
    """
    for block in read_maf(path_or_file):
        for s in block.seqs:
            fout.write(f">{s.name} {s.start} {s.size} {s.strand_char} {s.src_size}\n")
            fout.write(s.text + "\n")
        fout.write("=\n")


def fasta_to_maf(fasta_path: str, fout: TextIO, score: int = 9999) -> None:
    """Whole-FASTA -> one single-sequence MAF block per record.

    Degenerate 1-genome leaf ("fake mugsy"); reference: lib/profiles/m_maf.ml.
    """
    from paramugsy_tpu_torch.formats.fasta import read_fasta

    fout.write(MAF_HEADER + "\n")
    for name, seq in read_fasta(fasta_path):
        block = MafBlock(
            seqs=[
                MafSequence(
                    name=name,
                    start=0,
                    size=len(seq),
                    strand=FORWARD,
                    src_size=len(seq),
                    text=seq,
                )
            ],
            score=score,
            attrs={"label": "1", "mult": "1"},
        )
        fout.write(block.a_line() + "\n")
        for s in block.seqs:
            fout.write(s.to_line() + "\n")
        fout.write("\n")


def read_xmfa(path_or_file) -> Iterator[MafBlock]:
    """Read XMFA (the mugsyWGA --aln format) back into MAF blocks.

    Inverse of maf_to_xmfa: records are ``>name start size strand
    src_size`` + sequence lines, blocks terminated by ``=``.
    """
    close = False
    if isinstance(path_or_file, (str, os.PathLike)):
        fin: TextIO = open(path_or_file)
        close = True
    else:
        fin = path_or_file
    try:
        seqs: list[MafSequence] = []
        header: Optional[tuple] = None
        chunks: list[str] = []

        def flush_seq():
            nonlocal header, chunks
            if header is not None:
                name, start, size, strand, src = header
                seqs.append(
                    MafSequence(
                        name=name, start=start, size=size, strand=strand,
                        src_size=src, text="".join(chunks),
                    )
                )
            header, chunks = None, []

        for line in fin:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line == "=":
                flush_seq()
                if seqs:
                    yield MafBlock(seqs=seqs, score=0)
                seqs = []
            elif line.startswith(">"):
                flush_seq()
                parts = line[1:].split()
                if len(parts) != 5:
                    raise ValueError(f"bad XMFA header: {line!r}")
                header = (
                    parts[0], int(parts[1]), int(parts[2]),
                    FORWARD if parts[3] == "+" else REVERSE, int(parts[4]),
                )
            else:
                chunks.append(line)
        flush_seq()
        if seqs:
            yield MafBlock(seqs=seqs, score=0)
    finally:
        if close:
            fin.close()
