"""The port's self-alignment path against paramugsy_tpu on the CPU: repeat
seeding (`repeat_cluster_packed`), `align_self` and its windowed form,
``align -duplications`` and the ``repeats`` command.

The same numpy-seeded inputs go through both packages (the reference
under JAX_PLATFORMS=cpu, the port on ``device="cpu"``).  Everything here
is integer, so nothing has a tolerance: the packed seed vector must be
bit-identical, masked slots included; entry lists must have equal
fields; delta and MAF files must be byte-identical.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paramugsy_tpu import cli as ref_cli
from paramugsy_tpu import pipeline as ref_pipe
from paramugsy_tpu.ops import align_pair as ref_ap
from paramugsy_tpu.ops import encode as ref_encode
from paramugsy_tpu.ops import engines as ref_engines
from paramugsy_tpu.ops import seeding as ref_seeding
from paramugsy_tpu_torch import cli as port_cli
from paramugsy_tpu_torch import convert
from paramugsy_tpu_torch import pipeline as port_pipe
from paramugsy_tpu_torch.ops import align_pair as port_ap
from paramugsy_tpu_torch.ops import engines as port_engines
from paramugsy_tpu_torch.ops import seeding as port_seeding
from tests import test_ops, test_pipeline

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REALISTIC_G1 = os.path.join(ROOT, "tests", "data", "realistic", "g1.fa")


def _fields(entries):
    return [
        (e.ref_name, e.query_name, e.ref_len, e.query_len,
         (e.ref_range.start, e.ref_range.end), (e.query_range.start, e.query_range.end),
         [(g.start, g.end) for g in e.ref_gaps], [(g.start, g.end) for g in e.query_gaps])
        for e in entries
    ]


def _three_copy():
    """tests/test_ops.py::TestAlignSelf's three-copy repeat."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, size=16000).astype(np.int8)
    g[6000:6500] = g[1000:1500]
    g[11000:11500] = g[1000:1500]
    return g


def _n_runs():
    """A direct duplication cut by a run of N, and N runs elsewhere (the
    k-mers that span them are invalid)."""
    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, size=20000).astype(np.int8)
    g[9000:9800] = g[1000:1800]
    g[3000:3100] = 4
    g[9500:9530] = 4
    g[15000:15500] = 4
    return g


def _palindrome():
    """A 1 kb reverse-complement palindrome (its own inverted copy) and a
    direct duplication."""
    rng = np.random.default_rng(22)
    g = rng.integers(0, 4, size=20000).astype(np.int8)
    g[8500:9000] = (3 - g[8000:8500])[::-1]
    g[15000:15700] = g[2000:2700]
    return g


def _realistic_chromosome():
    """g1.g1_chr of tests/data/realistic (252,396 bp)."""
    return ref_encode.encode(ref_pipe.load_genome(REALISTIC_G1).seqs["g1.g1_chr"])


INPUTS = {
    "planted": lambda: test_ops.TestAlignSelf()._genome(),
    "three_copy": _three_copy,
    "random": lambda: np.random.default_rng(11).integers(0, 4, size=20000).astype(np.int8),
    "n_runs": _n_runs,
    "palindrome": _palindrome,
    "realistic_chr": _realistic_chromosome,
}
# (input, max_seeds): the last one is smaller than the merged runs of its
# input, so align_self's bucket ladder grows it once.
CASES = {name: (name, 1 << 15) for name in INPUTS}
CASES["retry"] = ("realistic_chr", 1 << 9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_repeat_cluster_packed_equals_reference(case):
    name, max_seeds = CASES[case]
    g = INPUTS[name]()
    padded = ref_encode.pad_to(g, ref_encode.bucket_size(len(g)))
    want = np.asarray(
        ref_seeding.repeat_cluster_packed(
            jnp.asarray(padded), None, jnp.int32(len(g)), k=15, max_seeds=max_seeds
        )
    )
    got = port_seeding.repeat_cluster_packed(
        torch.from_numpy(padded), len(g), k=15, max_seeds=max_seeds
    ).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    n_runs, m_compute = int(want[4]), int(want[2])
    assert (n_runs > m_compute) == (case == "retry")


def test_find_repeat_seeds_fields_equal_reference():
    """Every field of the seed set, masked slots included, on both
    strands' streams."""
    g = test_ops.TestAlignSelf()._genome()
    padded = ref_encode.pad_to(g, ref_encode.bucket_size(len(g)))
    rc = ref_seeding.revcomp_on_device(jnp.asarray(padded), len(g))
    want = ref_seeding.find_repeat_seeds(jnp.asarray(padded), rc, k=15, max_seeds=4096)
    t = torch.from_numpy(padded)
    got = port_seeding.find_repeat_seeds(
        t, port_seeding.revcomp_on_device(t, len(g)), k=15, max_seeds=4096
    )
    assert int(got.mask.sum()) == int(np.asarray(want.mask).sum()) > 0
    for field in want._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(),
            np.asarray(getattr(want, field)).astype(getattr(got, field).numpy().dtype),
            err_msg=field,
        )


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_self_equals_reference(case):
    name, max_seeds = CASES[case]
    g = INPUTS[name]()
    cfg = ref_ap.AlignConfig(max_seeds=max_seeds)
    want = ref_ap.align_self(g, "G.c", cfg)
    port_engines.reset_counts()
    got = port_ap.align_self(g, "G.c", convert.align_config(cfg), device="cpu")
    assert _fields(got) == _fields(want)
    assert port_engines.COUNTS["repeatcluster-cpu"] == (2 if case == "retry" else 1)
    if name == "realistic_chr":
        assert len(want) == 62
    if name == "planted":
        assert len(want) == 2


def test_windowed_align_self_equals_reference():
    """The 60 kb genome of tests/test_ops.py::TestWindowedAlignment with 16
    kb windows: five windows aligned with themselves, ten window pairs."""
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, size=60000).astype(np.int8)
    g[40000:41000] = g[2000:3000]
    g[52000:52600] = (3 - g[5000:5600])[::-1]
    g[21000:21400] = g[20000:20400]
    cfg = ref_ap.AlignConfig(window=1 << 14, window_overlap=1 << 12)
    want = ref_ap.align_self(g, "G.c", cfg)
    port_engines.reset_counts()
    got = port_ap.align_self(g, "G.c", convert.align_config(cfg), device="cpu")
    assert want and _fields(got) == _fields(want)
    assert port_engines.COUNTS["repeatcluster-cpu"] == 5
    assert port_engines.COUNTS["seedcluster-cpu"] == 10


def test_self_long_gap_on_plain_wavefront(monkeypatch):
    """A duplication whose copy holds a 4.5 kb random island: under
    break_len 8192 its chain keeps one gap over 4096 bp on both sides,
    which the port sends to the plain K1 + K2 and the reference to its
    native banded engine."""
    g = chip_smoke.self_island_genome(40_000, n_copies=1, length=14_000, island=4500)
    cfg = ref_ap.AlignConfig(break_len=chip_smoke.SELF_ISLAND_BREAK_LEN)
    monkeypatch.setenv("PARAMUGSY_DEVICE_DP", "0")
    ref_engines.reset_counts()
    want = ref_ap.align_self(g, "G.c", cfg)
    monkeypatch.setenv("PARAMUGSY_DEVICE_DP", "1")
    port_engines.reset_counts()
    got = port_ap.align_self(g, "G.c", convert.align_config(cfg), device="cpu")
    assert want and _fields(got) == _fields(want)
    assert ref_engines.COUNTS["native-banded"] == 1
    assert port_engines.COUNTS["device-wavefront"] == 1
    assert "native-banded" not in port_engines.COUNTS


def test_duplications_maf_equals_reference(tmp_path):
    """align_fastas with duplications on tests/test_pipeline.py::
    TestDuplications's two genomes: byte-identical MAF with dup blocks."""
    paths = test_pipeline.TestDuplications()._fastas(tmp_path)
    ref_pipe.align_fastas(
        paths, str(tmp_path / "ref.maf"), ref_pipe.PipelineConfig(duplications=True)
    )
    port_engines.reset_counts()
    blocks = port_pipe.align_fastas(
        paths, str(tmp_path / "port.maf"), port_pipe.PipelineConfig(duplications=True),
        device="cpu",
    )
    assert (tmp_path / "port.maf").read_bytes() == (tmp_path / "ref.maf").read_bytes()
    assert any(b.attrs["label"].startswith("dup") for b in blocks)
    assert port_engines.COUNTS["repeatcluster-cpu"] == 2  # one per genome


def test_repeats_cli_equals_reference(tmp_path):
    """The repeats command on the realistic g1.fa (a chromosome and a
    plasmid): byte-identical delta and MAF files."""
    out = {}
    for name, main, extra in (
        ("ref", ref_cli.main, []), ("port", port_cli.main, ["-device", "cpu"]),
    ):
        delta, maf = tmp_path / f"{name}.delta", tmp_path / f"{name}.maf"
        argv = ["repeats", "-seq", REALISTIC_G1, "-out_delta", str(delta),
                "-out_maf", str(maf), *extra]
        assert main(argv) == 0
        out[name] = (delta.read_bytes(), maf.read_bytes())
    assert out["port"] == out["ref"]
    assert out["port"][0].startswith(REALISTIC_G1.encode())
    assert out["port"][1].count(b"\na ") > 0


def test_repeats_cli_needs_a_card_by_default(tmp_path, monkeypatch):
    """-device defaults to cuda, which raises where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["repeats", "-seq", REALISTIC_G1, "-out_delta", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
