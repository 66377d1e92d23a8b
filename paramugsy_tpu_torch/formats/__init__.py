from paramugsy_tpu_torch.formats.maf import MafBlock, MafSequence, read_maf, write_maf
from paramugsy_tpu_torch.formats.delta import DeltaEntry, read_delta, DeltaWriter
from paramugsy_tpu_torch.formats.fasta import read_fasta, write_fasta

__all__ = [
    "MafBlock",
    "MafSequence",
    "read_maf",
    "write_maf",
    "DeltaEntry",
    "read_delta",
    "DeltaWriter",
    "read_fasta",
    "write_fasta",
]
