"""Guide tree (counterpart of paramugsy_tpu.tree.guide_tree): UPGMA over
the port's device distance matrix.  `GuideTree`, `upgma` and
`parse_newick` are the reference's; its module imports no JAX at load.
"""
from __future__ import annotations

import numpy as np
import torch

from paramugsy_tpu.tree.guide_tree import GuideTree, upgma
from paramugsy_tpu_torch.tree.distance import distance_matrix


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
