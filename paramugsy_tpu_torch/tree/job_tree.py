"""Job tree: the execution plan over genomes.

Reproduces the reference's planner exactly (lib/base/pm_job.ml:27-91): the
guide tree is flattened to an ordered genome list, then recursively halved.
Leaves holding <= max_seqs genomes are multi-genome alignment runs
(``Mugsy``), single genomes are degenerate (``Fake_mugsy``), and internal
nodes are profile merges.  ``pairwise`` enumerates the nucmer searches each
node needs: all-pairs within a leaf, left-leaves x right-leaves for a merge
node.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

from paramugsy_tpu_torch.tree.guide_tree import GuideTree


@dataclass
class JobTree:
    kind: str  # "profile" | "mugsy" | "fake_mugsy"
    genomes: list[str] = field(default_factory=list)  # leaf payload
    left: Optional["JobTree"] = None
    right: Optional["JobTree"] = None

    def to_list(self) -> list[str]:
        if self.kind == "profile":
            return self.left.to_list() + self.right.to_list()
        return self.genomes

    def pairwise(self) -> list[tuple[str, str]]:
        """The nucmer searches this node needs (pm_job.ml:83-91)."""
        if self.kind == "profile":
            return [
                (a, b) for a in self.left.to_list() for b in self.right.to_list()
            ]
        if self.kind == "mugsy":
            gs = self.genomes
            return [(gs[i], gs[j]) for i in range(len(gs)) for j in range(i + 1, len(gs))]
        return []

    def all_pairwise(self) -> list[tuple[str, str]]:
        """Every search in the whole tree, depth-first order."""
        out: list[tuple[str, str]] = []
        for node in self.walk():
            out.extend(node.pairwise())
        return out

    def walk(self) -> Iterator["JobTree"]:
        """Depth-first, children before self (execution dependency order)."""
        if self.kind == "profile":
            yield from self.left.walk()
            yield from self.right.walk()
        yield self

    def depth(self) -> int:
        if self.kind == "profile":
            return 1 + max(self.left.depth(), self.right.depth())
        return 0

    def pp(self, indent: int = 0) -> str:
        pad = "  " * indent
        if self.kind == "profile":
            return (
                f"{pad}profile\n"
                + self.left.pp(indent + 1)
                + "\n"
                + self.right.pp(indent + 1)
            )
        return f"{pad}{self.kind}: {', '.join(self.genomes)}"


def make_job_tree(ordered_genomes: list[str], max_seqs: int) -> JobTree:
    """Recursive halving of the guide-tree leaf order (pm_job.ml:62-77)."""
    n = len(ordered_genomes)
    if n == 0:
        raise ValueError("no genomes")
    if n == 1:
        return JobTree(kind="fake_mugsy", genomes=list(ordered_genomes))
    if n <= max_seqs:
        return JobTree(kind="mugsy", genomes=list(ordered_genomes))
    half = n // 2
    return JobTree(
        kind="profile",
        left=make_job_tree(ordered_genomes[:half], max_seqs),
        right=make_job_tree(ordered_genomes[half:], max_seqs),
    )


def job_tree_of_guide_tree(tree: GuideTree, max_seqs: int) -> JobTree:
    return make_job_tree(tree.leaves(), max_seqs)
