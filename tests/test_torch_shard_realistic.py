"""The port's ``align_fastas_sharded`` on the realistic fixture against
the reference's, in one process on the CPU: the input of the reference's
three-mode test (tests/test_quality_fixture.py), five genomes with
rearrangements and contigs of unequal length, so the batch's one shared
bucket is wider than most rows.  Apart from tests/test_torch_shard.py
because each package takes ~20 s on it here."""
import os

import jax
import torch

import chip_smoke
from paramugsy_tpu.parallel import collective as ref_collective
from paramugsy_tpu.parallel import mesh as ref_mesh
from paramugsy_tpu_torch.ops import engines
from paramugsy_tpu_torch.parallel import collective

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REALISTIC = [os.path.join(ROOT, "tests", "data", "realistic", f"g{i}.fa") for i in range(5)]


def test_realistic_maf_equals_reference(tmp_path):
    """The MAF's bytes, with the seedings that chip_smoke phase 14c
    expects of its refine run (the same pairwise phase: refinement acts
    after it)."""
    want = tmp_path / "ref.maf"
    ref_collective.align_fastas_sharded(
        REALISTIC, str(want),
        mesh=ref_mesh.make_mesh(n_pairs=8, n_kdim=1, devices=jax.devices("cpu")[:8]),
    )
    got = tmp_path / "port.maf"
    engines.reset_counts()
    collective.align_fastas_sharded(REALISTIC, str(got), devices=["cpu"] * 8)
    assert got.read_bytes() == want.read_bytes()
    assert engines.COUNTS.get("seedcluster-cpu") == chip_smoke.SHARDED_REALISTIC_SEEDCLUSTER
