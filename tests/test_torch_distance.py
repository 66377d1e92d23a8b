"""The port's guide-tree distances against paramugsy_tpu.tree.distance:
k-mer sketches, the Jaccard product and Mash distances exactly equal for
k = 4 .. 8, and the same UPGMA tree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paramugsy_tpu.tree import distance as ref_dist
from paramugsy_tpu.tree.guide_tree import guide_tree_of_seqs as ref_tree
from paramugsy_tpu_torch.tree import distance as port_dist
from paramugsy_tpu_torch.tree.guide_tree import guide_tree_of_seqs as port_tree

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _genomes(seed: int = 0, n: int = 5000, count: int = 5):
    """A family of diverged genomes of unequal lengths, with N runs."""
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 4, size=n).astype(np.int8)
    out = []
    for g in range(count):
        x = anc.copy()
        m = rng.random(n) < 0.01 * (g + 1)
        x[m] = ((x[m] + 1) % 4).astype(np.int8)
        x[rng.integers(0, n - 40) :][:30] = 4
        out.append(x[: n - 97 * g])
    return out


@pytest.mark.parametrize("k", [4, 5, 6, 7, 8])
def test_sketch_jaccard_and_distances_equal_reference(k):
    codes = _genomes(k)
    for c in codes[:2]:
        want = np.asarray(ref_dist.kmer_sketch(jnp.asarray(c), k=k))
        got = port_dist.kmer_sketch(torch.from_numpy(c), k).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    sk = np.stack([np.asarray(ref_dist.kmer_sketch(jnp.asarray(c), k=k)) for c in codes])
    np.testing.assert_array_equal(
        port_dist.jaccard_matrix(torch.from_numpy(sk)).numpy(),
        np.asarray(ref_dist.jaccard_matrix(jnp.asarray(sk))),
    )
    np.testing.assert_array_equal(
        port_dist.distance_matrix(codes, k=k, device=CPU),
        ref_dist.distance_matrix(codes, k=k),
    )


def test_guide_tree_newick_equals_reference():
    codes = _genomes(11, count=6)
    names = [f"g{i}" for i in range(len(codes))]
    want = ref_tree(codes, names, k=8)
    got = port_tree(codes, names, k=8, device=CPU)
    assert got.to_newick() == want.to_newick()
    assert got.depth() >= 2
    assert port_tree(codes[:1], names[:1], device=CPU).to_newick() == "g0;"
