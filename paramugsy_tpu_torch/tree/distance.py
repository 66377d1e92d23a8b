"""Genome distances on the device (counterpart of
paramugsy_tpu.tree.distance).

Each genome becomes a dense k-mer presence sketch (float32 [4^k]); one
matrix product over the genome axis gives the pairwise intersections:

    inter = S @ S.T,  union = |A| + |B| - inter,  J = inter / union
    mash distance D = -1/k * ln(2J / (1 + J))      (Ondov et al. 2016)

The product stays `torch.matmul`, as the reference left it to XLA outside
any Pallas kernel.  Its operands are 0/1 and its sums integers below
2^24, so it is exact in float32; PyTorch's default keeps TF32 off for
float32 products (``torch.backends.cuda.matmul.allow_tf32`` is False),
and even TF32 would hold 0/1 inputs exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from paramugsy_tpu_torch.ops.encode import bucket_size, kmer_codes


def kmer_sketch(codes: torch.Tensor, k: int = 8) -> torch.Tensor:
    """Dense presence vector over the 4^k k-mer space (float32 [4^k]):
    sort the valid k-mer codes, keep first occurrences, and set them."""
    km, valid = kmer_codes(codes, k)
    dim = 4**k
    s = torch.sort(torch.where(valid, km, dim)).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    sketch = torch.zeros(dim + 1, dtype=torch.float32, device=codes.device)
    sketch.index_fill_(0, s[first], 1.0)
    return sketch[:dim]


def jaccard_matrix(sketches: torch.Tensor) -> torch.Tensor:
    """Pairwise Jaccard similarity from presence sketches [G, D]."""
    inter = sketches @ sketches.T
    sizes = torch.diagonal(inter)
    union = sizes[:, None] + sizes[None, :] - inter
    return inter / torch.clamp(union, min=1.0)


def mash_distance(jaccard: np.ndarray, k: int = 8) -> np.ndarray:
    """Mash distance from Jaccard similarity (copied from the reference)."""
    j = np.clip(np.asarray(jaccard), 1e-9, 1.0)
    d = -np.log(2 * j / (1 + j)) / k
    np.fill_diagonal(d, 0.0)
    return np.maximum(d, 0.0)


def distance_matrix(
    genome_codes: list[np.ndarray], k: int = 8, *, device: torch.device
) -> np.ndarray:
    """Pairwise Mash distances for a list of encoded genomes, computed on
    `device`.  Rows are padded with N (code 4) to one bucket, as in the
    reference; N windows are invalid, so padding never enters a sketch."""
    n_max = bucket_size(max(len(c) for c in genome_codes))
    batch = np.full((len(genome_codes), n_max), 4, dtype=np.int8)
    for i, c in enumerate(genome_codes):
        batch[i, : len(c)] = c
    codes = torch.from_numpy(batch).to(device)
    sketches = torch.stack([kmer_sketch(row, k) for row in codes])
    return mash_distance(jaccard_matrix(sketches).cpu().numpy(), k=k)
