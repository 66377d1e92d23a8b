"""End-to-end multiple alignment: FASTA list -> one MAF (counterpart of
paramugsy_tpu.pipeline, the sequential ``align -sequential`` path).

Guide tree (k-mer sketches and their Jaccard product on the device) ->
binary job tree -> recursive execution, where every node is a
single-genome leaf or a profile merge fed by pairwise alignments of the
port's `align_pair` (seeding and clustering on the device, long segments
on the wavefront kernels).  Every function that computes takes an
explicit ``device``; one `device_cache` of padded genome codes serves all
pairs of a run.

With ``duplications`` set, every genome is also aligned against itself
(`align_self`) and its segmental duplications follow the LCBs as
``dup<N>`` blocks (`duplication_blocks`).

The host code is copied from the reference, whose module imports JAX
through its aligner.  `genome_pair_deltas_batch` (a chunk of genome
pairs) is the task of the concurrent executor (`runtime.executor`, the
default ``align``), which runs the same functions on worker threads.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from paramugsy_tpu_torch.coords.range import FORWARD
from paramugsy_tpu_torch.formats.delta import DeltaEntry
from paramugsy_tpu_torch.formats.delta_maf import delta_to_maf_blocks
from paramugsy_tpu_torch.formats.fasta import normalize_header, read_fasta, species_of_path
from paramugsy_tpu_torch.formats.maf import MAF_HEADER, MafBlock, MafSequence, read_maf, write_maf
from paramugsy_tpu_torch.lcb.merge import merge_blocks
from paramugsy_tpu_torch.lcb.score import score_blocks
from paramugsy_tpu_torch.ops.align_pair import AlignConfig, align_pair, align_self
from paramugsy_tpu_torch.ops.encode import encode
from paramugsy_tpu_torch.ops.extend import Scoring
from paramugsy_tpu_torch.tree.guide_tree import GuideTree, guide_tree_of_seqs, parse_newick
from paramugsy_tpu_torch.tree.job_tree import JobTree, make_job_tree
from paramugsy_tpu_torch.utils.obs import METRICS
from paramugsy_tpu_torch.utils.platform import resolve_device


@dataclass
class Genome:
    name: str  # species
    seqs: dict[str, str]  # normalized record name -> sequence

    @property
    def total_length(self) -> int:
        return sum(len(s) for s in self.seqs.values())

    def concat_codes(self) -> np.ndarray:
        """All records' codes, each followed by one N separator."""
        parts = []
        for s in self.seqs.values():
            parts.append(encode(s))
            parts.append(np.array([4], dtype=np.int8))
        return np.concatenate(parts) if parts else np.zeros(0, np.int8)


def load_genome(path: str) -> Genome:
    species = species_of_path(path)
    seqs: dict[str, str] = {}
    for header, seq in read_fasta(path):
        seqs[normalize_header(header, species)] = seq.upper()
    return Genome(name=species, seqs=seqs)


@dataclass
class PipelineConfig:
    """The reference's PipelineConfig (same fields, same defaults)."""

    max_seqs: int = 2  # seqs-per-mugsy; binary merge all the way by default
    min_length: int = 30  # mugsyWGA --minlength role
    emit_unique: bool = True  # False = the reference's -skipunique
    refine: bool = False  # mugsyWGA --refine role: per-block MSA polish
    refine_max_cols: int = 50_000  # skip refining blocks wider than this
    chain_gap: int = 1000  # collinear chain/bridge gap for LCB selection
    align: AlignConfig = field(default_factory=AlignConfig)
    distance_k: int = 8
    duplications: bool = False  # genome-vs-self duplications (mugsyWGA --duplications)
    dup_list: list = field(default_factory=list)  # precomputed dup MAF paths
    # Optional Newick guide tree; leaf names are genome (species) names.
    guide_tree_newick: Optional[str] = None
    progress: Optional[Callable[[str], None]] = None

    def log(self, msg: str) -> None:
        if self.progress:
            self.progress(msg)


def config_from_dict(d: dict) -> PipelineConfig:
    """A PipelineConfig from a plain dict (JSON config files): top-level
    keys set PipelineConfig fields, an ``align`` object AlignConfig fields,
    and ``align.scoring`` the DP scores."""
    d = dict(d)
    align_d = dict(d.pop("align", {}))
    scoring_d = align_d.pop("scoring", None)
    align = AlignConfig(**align_d)
    if scoring_d:
        align.scoring = Scoring(**scoring_d)
    known = {f for f in PipelineConfig.__dataclass_fields__ if f not in ("align", "progress")}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return PipelineConfig(align=align, **d)


def load_config(path: str) -> PipelineConfig:
    with open(path) as f:
        return config_from_dict(json.load(f))


def genome_pair_deltas(
    a: Genome,
    b: Genome,
    cfg: AlignConfig,
    device_cache: dict | None = None,
    *,
    device: torch.device,
) -> list[DeltaEntry]:
    """All-contig-pairs pairwise alignment of two genomes (nucmer role)."""
    out: list[DeltaEntry] = []
    for ra_name, ra in a.seqs.items():
        for rb_name, rb in b.seqs.items():
            out.extend(
                align_pair(ra, rb, ra_name, rb_name, cfg, device_cache, device=device)
            )
    return out


def genome_pair_deltas_batch(
    genome_pairs: list[tuple[Genome, Genome]],
    cfg: AlignConfig,
    device_cache: dict | None = None,
    *,
    device: torch.device,
) -> list[list[DeltaEntry]]:
    """Deltas for a chunk of genome pairs (the concurrent executor's task),
    one `genome_pair_deltas` each: the reference's batched seeding gives
    the same entries."""
    return [genome_pair_deltas(a, b, cfg, device_cache, device=device) for a, b in genome_pairs]


def fake_mugsy_blocks(g: Genome) -> list[MafBlock]:
    """Single-genome degenerate leaf (lib/profiles/m_maf.ml role)."""
    return [
        MafBlock(
            seqs=[
                MafSequence(
                    name=name, start=0, size=len(seq), strand=FORWARD,
                    src_size=len(seq), text=seq,
                )
            ],
            score=len(seq),
            attrs={"label": "1", "mult": "1"},
        )
        for name, seq in g.seqs.items()
    ]


class Aligner:
    """Executes the job tree sequentially in one process, on `device`.

    ``delta_pool``: precomputed pairwise delta entries; pairs it covers are
    not recomputed, the others are aligned on the device.
    """

    def __init__(
        self,
        genomes: list[Genome],
        cfg: PipelineConfig | None = None,
        delta_pool: list[DeltaEntry] | None = None,
        *,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg or PipelineConfig()
        self.device = resolve_device(device)
        self.genomes = {g.name: g for g in genomes}
        self._uid = 0
        # Padded genome codes on the device, shared by every pair of the
        # run ((contig name, length) -> tensor).
        self.device_cache: dict = {}
        # (ref genome, query genome) -> pooled entries.
        self._pool: dict = {}
        if delta_pool:
            contig_genome = {contig: g.name for g in genomes for contig in g.seqs}
            for e in delta_pool:
                ga = contig_genome.get(e.ref_name)
                gb = contig_genome.get(e.query_name)
                if ga is None or gb is None or ga == gb:
                    continue
                self._pool.setdefault((ga, gb), []).append(e)

    def _next_uid(self) -> str:
        self._uid += 1
        return f"n{self._uid:04d}"

    def guide_tree(self) -> GuideTree:
        if self.cfg.guide_tree_newick:
            tree = parse_newick(self.cfg.guide_tree_newick)
            leaves = set(tree.leaves())
            missing = set(self.genomes) - leaves
            extra = leaves - set(self.genomes)
            if missing or extra:
                raise ValueError(
                    f"guide tree/genome mismatch: missing={sorted(missing)} "
                    f"extra={sorted(extra)}"
                )
            return tree
        with METRICS.phase("guide_tree", items=len(self.genomes)):
            names = list(self.genomes)
            codes = [self.genomes[n].concat_codes() for n in names]
            return guide_tree_of_seqs(
                codes, names, k=self.cfg.distance_k, device=self.device
            )

    def job_tree(self) -> JobTree:
        return make_job_tree(self.guide_tree().leaves(), max(self.cfg.max_seqs, 2))

    def merge_lists(
        self, left: list[str], right: list[str],
        left_blocks: list[MafBlock], right_blocks: list[MafBlock],
    ) -> list[MafBlock]:
        deltas: list[DeltaEntry] = []
        with METRICS.phase("pairwise", items=len(left) * len(right)):
            for a in left:
                for b in right:
                    if (a, b) in self._pool:
                        deltas.extend(self._pool[a, b])
                    elif (b, a) in self._pool:
                        deltas.extend(e.swapped() for e in self._pool[b, a])
                    else:
                        self.cfg.log(f"pairwise {a} vs {b}")
                        deltas.extend(
                            genome_pair_deltas(
                                self.genomes[a], self.genomes[b], self.cfg.align,
                                self.device_cache, device=self.device,
                            )
                        )
        uid = self._next_uid()
        self.cfg.log(f"merge {len(left)}+{len(right)} genomes ({uid})")
        return merge_blocks(
            left_blocks,
            right_blocks,
            deltas,
            basename_left=f"l{uid}",
            basename_right=f"r{uid}",
            min_length=self.cfg.min_length,
            emit_unique=self.cfg.emit_unique,
            refine=self.cfg.refine,
            refine_max_cols=self.cfg.refine_max_cols,
            chain_gap=self.cfg.chain_gap,
            device=self.device,
        )

    def align_ordered(self, order: list[str]) -> list[MafBlock]:
        """Binary merge over an ordered genome list."""
        if len(order) == 1:
            return fake_mugsy_blocks(self.genomes[order[0]])
        half = len(order) // 2
        left, right = order[:half], order[half:]
        lb = self.align_ordered(left)
        rb = self.align_ordered(right)
        return self.merge_lists(left, right, lb, rb)

    def run_node(self, node: JobTree) -> list[MafBlock]:
        if node.kind == "fake_mugsy":
            return fake_mugsy_blocks(self.genomes[node.genomes[0]])
        if node.kind == "mugsy":
            return self.align_ordered(node.genomes)
        lb = self.run_node(node.left)
        rb = self.run_node(node.right)
        return self.merge_lists(node.left.to_list(), node.right.to_list(), lb, rb)

    def run(self) -> list[MafBlock]:
        tree = self.job_tree()
        self.cfg.log("job tree:\n" + tree.pp())
        return self.run_node(tree)


def duplication_blocks(
    genomes: list[Genome], cfg: PipelineConfig, *, device: torch.device
) -> list[MafBlock]:
    """Per-genome self-alignment on `device` -> duplication MAF blocks
    (label=dup*).

    The mugsyWGA --duplications role: each block pairs two copies of a
    segmental duplication within one genome (second row reverse-strand for
    inverted repeats).
    """
    out: list[MafBlock] = []
    for g in genomes:
        for name, seq in g.seqs.items():
            cfg.log(f"duplications {name}")
            entries = [
                e
                for e in align_self(seq, name, cfg.align, device=device)
                if e.alignment_length() >= cfg.min_length
            ]
            out.extend(delta_to_maf_blocks(entries, g.seqs, g.seqs))
    for b in out:
        b.attrs["label"] = "dup"
    return out


def gather_dup_blocks(
    genomes: list[Genome], cfg: PipelineConfig, *, device: torch.device
) -> list[MafBlock]:
    """Duplication blocks from self-alignment on `device` and/or
    precomputed MAFs (the -dup_list file-list form of mugsy_mugsy)."""
    dups: list[MafBlock] = []
    if cfg.duplications:
        dups.extend(duplication_blocks(genomes, cfg, device=device))
    for path in cfg.dup_list:
        for b in read_maf(path):
            b.attrs["label"] = "dup"
            dups.append(b)
    return dups


def finalize_blocks(
    blocks: list[MafBlock], dup_blocks: list[MafBlock] = ()
) -> list[MafBlock]:
    """Sequential LCB labels and sum-of-pairs scores; duplication blocks
    follow with ``dup<N>`` labels."""
    for i, b in enumerate(blocks):
        b.attrs["label"] = str(i + 1)
        b.attrs["mult"] = str(len(b.seqs))
    for i, b in enumerate(dup_blocks):
        b.attrs["label"] = f"dup{i + 1}"
        b.attrs["mult"] = str(len(b.seqs))
    out = list(blocks) + list(dup_blocks)
    score_blocks(out)
    return out


def align_fastas(
    fasta_paths: list[str],
    out_maf: str,
    cfg: PipelineConfig | None = None,
    *,
    device: str | torch.device | None = None,
) -> list[MafBlock]:
    """CLI-level entry: FASTA files -> MAF file, computed on `device`."""
    genomes = [load_genome(p) for p in fasta_paths]
    aligner = Aligner(genomes, cfg, device=device)
    blocks = finalize_blocks(
        aligner.run(), gather_dup_blocks(genomes, aligner.cfg, device=aligner.device)
    )
    write_maf(out_maf, blocks, header=MAF_HEADER)
    return blocks
