"""Guide tree (counterpart of paramugsy_tpu.tree.guide_tree): UPGMA over
the port's device distance matrix.  `GuideTree`, `upgma` and
`parse_newick` are copied from the reference unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from paramugsy_tpu_torch.tree.distance import distance_matrix


@dataclass
class GuideTree:
    name: Optional[str] = None  # leaf label
    left: Optional["GuideTree"] = None
    right: Optional["GuideTree"] = None
    height: float = 0.0

    @property
    def is_leaf(self) -> bool:
        return self.name is not None

    def leaves(self) -> list[str]:
        if self.is_leaf:
            return [self.name]
        return self.left.leaves() + self.right.leaves()

    def depth(self) -> int:
        if self.is_leaf:
            return 0
        return 1 + max(self.left.depth(), self.right.depth())

    def to_newick(self) -> str:
        def fmt(t: "GuideTree") -> str:
            if t.is_leaf:
                return t.name
            return f"({fmt(t.left)},{fmt(t.right)})"

        return fmt(self) + ";"


def upgma(dist: np.ndarray, names: list[str]) -> GuideTree:
    """Average-linkage agglomerative clustering into a binary tree."""
    n = len(names)
    if n == 1:
        return GuideTree(name=names[0])
    d = np.array(dist, dtype=np.float64)
    active: dict[int, tuple[GuideTree, int]] = {
        i: (GuideTree(name=names[i]), 1) for i in range(n)
    }
    d = d.copy()
    np.fill_diagonal(d, np.inf)
    # Grow the matrix as clusters merge; simple O(n^3), n is small.
    while len(active) > 1:
        keys = sorted(active.keys())
        sub = d[np.ix_(keys, keys)]
        flat = np.argmin(sub)
        a, b = keys[flat // len(keys)], keys[flat % len(keys)]
        ta, ca = active.pop(a)
        tb, cb = active.pop(b)
        merged = GuideTree(left=ta, right=tb, height=float(d[a, b]) / 2)
        # Average linkage update: reuse slot a.
        for k in active:
            d[a, k] = d[k, a] = (d[a, k] * ca + d[b, k] * cb) / (ca + cb)
        d[b, :] = d[:, b] = np.inf
        active[a] = (merged, ca + cb)
    (_, (tree, _)), = active.items()
    return tree


def parse_newick(s: str) -> GuideTree:
    """Parse a (possibly multifurcating) Newick string into a binary tree.

    Multifurcations are resolved left-heavy.  Branch lengths/labels after
    ':' are ignored, as in the reference's Newick handling.
    """
    s = s.strip().rstrip(";").strip()
    pos = 0

    def parse() -> GuideTree:
        nonlocal pos
        if s[pos] == "(":
            pos += 1  # (
            children = [parse()]
            while s[pos] == ",":
                pos += 1
                children.append(parse())
            assert s[pos] == ")", f"expected ) at {pos}"
            pos += 1
            # optional label/length after )
            while pos < len(s) and s[pos] not in ",()":
                pos += 1
            node = children[0]
            for c in children[1:]:
                node = GuideTree(left=node, right=c)
            return node
        start = pos
        while pos < len(s) and s[pos] not in ",():":
            pos += 1
        name = s[start:pos]
        while pos < len(s) and s[pos] not in ",()":
            pos += 1  # skip :length
        return GuideTree(name=name)

    return parse()


def guide_tree_of_seqs(
    genome_codes: list[np.ndarray],
    names: list[str],
    k: int = 8,
    *,
    device: torch.device,
) -> GuideTree:
    """Distance matrix on `device` -> UPGMA guide tree."""
    if len(names) == 1:
        return GuideTree(name=names[0])
    return upgma(distance_matrix(genome_codes, k=k, device=device), names)
